"""Manual cluster-connectivity diagnostic.

Parity with the reference's ``test_k8s_connection.py`` (SURVEY.md §3.3):
kubeconfig load, client creation, version API, namespace list, pod list —
each step prints a pass/fail marker. Implemented over the native REST client
(no kubernetes SDK).

The port's twin of the JAX package's ``scripts/check_connection.py``, through the
port's ``k8s/client.py`` and ``k8s/kubeconfig.py``; it touches no device.

Usage: python -m k8s_watcher_tpu_torch.check_connection [kubeconfig-path]
"""

from __future__ import annotations

import sys

from k8s_watcher_tpu_torch.k8s.client import K8sClient
from k8s_watcher_tpu_torch.k8s.kubeconfig import load_kubeconfig


def check_connection(kubeconfig: str = "./assets/config") -> bool:
    print(f"1. Loading kubeconfig: {kubeconfig}")
    try:
        conn = load_kubeconfig(kubeconfig)
        print(f"   OK - server: {conn.server}")
    except Exception as exc:
        print(f"   FAIL - {exc}")
        return False

    client = K8sClient(conn, request_timeout=10.0)

    print("2. Checking API version")
    try:
        print(f"   OK - {client.get_api_version()}")
    except Exception as exc:
        print(f"   FAIL - {exc}")
        return False

    print("3. Listing namespaces (limit 5)")
    try:
        names = client.list_namespaces(limit=5)
        print(f"   OK - {names}")
    except Exception as exc:
        print(f"   FAIL - {exc} (may not be implemented by a mock server)")

    print("4. Listing pods across all namespaces (limit 5)")
    try:
        body = client.list_pods(limit=5)
        for pod in body.get("items", []):
            meta = pod.get("metadata", {})
            phase = (pod.get("status") or {}).get("phase", "?")
            print(f"   - {meta.get('namespace')}/{meta.get('name')}: {phase}")
        print(f"   OK - {len(body.get('items', []))} pods, rv={body.get('metadata', {}).get('resourceVersion')}")
    except Exception as exc:
        print(f"   FAIL - {exc}")
        return False

    print("All connectivity checks passed")
    return True


if __name__ == "__main__":
    path = sys.argv[1] if len(sys.argv) > 1 else "./assets/config"
    sys.exit(0 if check_connection(path) else 1)
