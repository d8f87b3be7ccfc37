"""Mock-server end-to-end diagnostic.

Parity with the reference's ``test_k8s_mock.py`` (SURVEY.md §3.4): print the
kubeconfig target, list pods with per-pod detail, list namespaces (tolerating
mock gaps), then run a **bounded watch** — stop after 5 events or 5 seconds,
whichever comes first (the reference's pattern at test_k8s_mock.py:72-80).

The port's twin of the JAX package's ``scripts/check_mock.py``, through the
port's ``k8s/client.py`` and ``k8s/kubeconfig.py``; it touches no device.

Usage: python -m k8s_watcher_tpu_torch.check_mock [kubeconfig-path]
"""

from __future__ import annotations

import sys
import threading

from k8s_watcher_tpu_torch.k8s.client import K8sClient
from k8s_watcher_tpu_torch.k8s.kubeconfig import load_kubeconfig


def check_mock(kubeconfig: str = "./assets/config") -> bool:
    print(f"1. Kubeconfig: {kubeconfig}")
    try:
        conn = load_kubeconfig(kubeconfig)
        print(f"   OK - server: {conn.server}")
    except Exception as exc:
        print(f"   FAIL - {exc}")
        return False

    client = K8sClient(conn, request_timeout=10.0)

    print("2. Pod list (limit 5, with detail)")
    try:
        body = client.list_pods(limit=5)
        for pod in body.get("items", []):
            meta, status, spec = pod.get("metadata", {}), pod.get("status", {}), pod.get("spec", {})
            print(
                f"   - {meta.get('namespace')}/{meta.get('name')} "
                f"phase={status.get('phase')} node={spec.get('nodeName')} "
                f"labels={meta.get('labels')}"
            )
        print(f"   OK - {len(body.get('items', []))} pods")
    except Exception as exc:
        print(f"   FAIL - {exc}")
        return False

    print("3. Namespace list")
    try:
        print(f"   OK - {client.list_namespaces()}")
    except Exception as exc:
        print(f"   WARN - {exc} (may not be implemented in a mock)")

    print("4. Bounded watch: 5 events or 5 seconds")
    events = []
    rv = body.get("metadata", {}).get("resourceVersion")
    stop = threading.Event()

    def consume():
        try:
            for raw in client.watch_pods(resource_version=rv, timeout_seconds=5):
                obj = raw.get("object", {})
                meta = obj.get("metadata", {})
                print(f"   event: {raw.get('type')} {meta.get('namespace')}/{meta.get('name')}")
                events.append(raw)
                if len(events) >= 5 or stop.is_set():
                    return
        except Exception as exc:
            print(f"   watch ended: {exc}")

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=5.0)
    stop.set()
    print(f"   OK - {len(events)} events in the window")
    print("Mock diagnostics complete")
    return True


if __name__ == "__main__":
    path = sys.argv[1] if len(sys.argv) > 1 else "./assets/config"
    sys.exit(0 if check_mock(path) else 1)
