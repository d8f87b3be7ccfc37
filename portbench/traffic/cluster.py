"""A seeded GPU cluster as an apiserver serves it: its pods, the churn a
WATCH delivers, and their encoders.

:class:`GpuCluster` builds the pods a LIST returns and a finite churn, as
``chip_smoke.py``'s watcher phases replay it; :meth:`GpuCluster.open_churn`
is the endless churn of a steady cluster, which the benchmark's watcher cell
offers on a fixed schedule. Each pod is 2-4 KiB of JSON, as the apiserver
serves it, and :meth:`_PodSpec.encode` renders one at a state with its fixed
parts serialized once. Nodes are :func:`portbench.traffic.stub.node`'s. The
module imports nothing of the port.
"""

from __future__ import annotations

import heapq
import itertools
import json
import random

from portbench.traffic.stub import GPU_KEY, GPU_PRESENT_LABEL, GPU_PRODUCT, GPU_PRODUCT_LABEL, T0, node

WATCHED_NAMESPACES = ("default", "production", "monitoring", "kube-system")
UNWATCHED_NAMESPACE = "batch"
JOBSET_LABEL = "jobset.sigs.k8s.io/jobset-name"
REPLICATED_LABEL = "jobset.sigs.k8s.io/replicatedjob-name"
INDEX_LABEL = "apps.kubernetes.io/pod-index"
CPU_NODES = 8
# the open churn's GPU worker episodes: a terminal event (Failed, Succeeded,
# or DELETED), the DELETED of a pod that ended, then the replacement's ADDED
# (Pending), Running and Ready; each step lands a random number of the
# stream's positions after the one before it, EPISODE_GAP on average
TERMINALS = ("Failed", "Succeeded", "DELETED")
EPISODE_GAP = 500

__all__ = ["CPU_NODES", "GPU_KEY", "GPU_PRESENT_LABEL", "GPU_PRODUCT", "GPU_PRODUCT_LABEL", "GpuCluster",
           "INDEX_LABEL", "JOBSET_LABEL", "REPLICATED_LABEL", "T0", "UNWATCHED_NAMESPACE", "WATCHED_NAMESPACES"]


def _pod_status(phase: str, ready: bool, restarts: int, host_ip: str, pod_ip: str, image: str) -> dict:
    flag = "True" if ready else "False"
    if phase == "Running":
        state = {"running": {"startedAt": T0}}
    elif phase in ("Failed", "Succeeded"):
        state = {"terminated": {"exitCode": int(phase == "Failed"), "reason": "Error" if phase == "Failed" else
                                "Completed", "startedAt": T0, "finishedAt": T0}}
    else:
        state = {"waiting": {"reason": "ContainerCreating"}}
    return {
        "phase": phase,
        "conditions": [{"type": kind, "status": status, "lastTransitionTime": T0} for kind, status in (
            ("PodScheduled", "True"), ("Initialized", "True"), ("ContainersReady", flag), ("Ready", flag))],
        "hostIP": host_ip, "podIP": pod_ip, "startTime": T0, "qosClass": "Burstable",
        "containerStatuses": [
            {"name": "main", "ready": ready, "restartCount": restarts, "started": phase == "Running",
             "image": image, "state": state},
            {"name": "log-agent", "ready": ready, "restartCount": 0, "started": phase == "Running",
             "image": "registry.example.com/log-agent:0.9.1", "state": state},
        ],
    }


_encode = json.JSONEncoder(separators=(",", ":")).encode
# a resourceVersion and a restart count no serialized pod holds otherwise, in
# the context that places them
_MARK_RV, _MARK_COUNT = 918273645, 827364519
_RV_MARK = b'"resourceVersion":"%d"' % _MARK_RV
_RESTARTS_MARK = b'"restartCount":%d' % _MARK_COUNT


class _PodSpec:
    """One pod's fixed parts: identity, labels, owner, placement, containers.
    ``pod()`` renders it at a state as a dict, ``encode()`` as the same JSON
    bytes with the fixed parts serialized once."""

    __slots__ = ("namespace", "uid", "gpus", "jobset", "metadata", "spec", "ips", "image", "_parts", "_status", "_frames")

    def __init__(self, rng, *, name, namespace, uid, node, node_ip, gpus, labels, owner_kind, owner_name):
        self.namespace, self.uid, self.gpus = namespace, uid, gpus
        self.jobset = f"{namespace}/{labels[JOBSET_LABEL]}/{labels[REPLICATED_LABEL]}" if JOBSET_LABEL in labels \
            else None
        self.image = "registry.example.com/train:1.4.2" if gpus else "registry.example.com/service:2.7.0"
        requests = {"cpu": "4", "memory": "16Gi"}
        limits = {"cpu": "8", "memory": "32Gi"}
        if gpus:
            requests[GPU_KEY] = limits[GPU_KEY] = str(gpus)
        env = [{"name": f"APP_SETTING_{i:02d}", "value": f"{rng.getrandbits(96):024x}"}
               for i in range(rng.randrange(0, 24))]
        self.metadata = {
            "name": name, "generateName": name.rsplit("-", 1)[0] + "-", "namespace": namespace, "uid": uid,
            "creationTimestamp": T0, "labels": labels,
            "annotations": {"kubectl.kubernetes.io/default-container": "main", "prometheus.io/scrape": "true"},
            "ownerReferences": [{"apiVersion": "batch/v1" if owner_kind == "Job" else "apps/v1",
                                 "kind": owner_kind, "name": owner_name, "uid": f"owner-{owner_name}",
                                 "controller": True, "blockOwnerDeletion": True}],
        }
        self.spec = {
            "nodeName": node, "serviceAccountName": "default", "restartPolicy": "Never" if gpus else "Always",
            "schedulerName": "default-scheduler", "priority": 0, "terminationGracePeriodSeconds": 30,
            "containers": [
                {"name": "main", "image": self.image, "command": ["/bin/entrypoint"],
                 "args": ["--config", "/etc/app/config.yaml"], "env": env,
                 "resources": {"requests": requests, "limits": limits},
                 "ports": [{"containerPort": 8080, "name": "http", "protocol": "TCP"}],
                 "volumeMounts": [{"name": "config", "mountPath": "/etc/app"},
                                  {"name": "kube-api-access", "readOnly": True,
                                   "mountPath": "/var/run/secrets/kubernetes.io/serviceaccount"}],
                 "readinessProbe": {"httpGet": {"path": "/healthz", "port": 8080}, "periodSeconds": 10}},
                {"name": "log-agent", "image": "registry.example.com/log-agent:0.9.1",
                 "resources": {"requests": {"cpu": "100m", "memory": "128Mi"}},
                 "volumeMounts": [{"name": "logs", "mountPath": "/var/log/app"}]},
            ],
            "tolerations": [{"key": GPU_KEY, "operator": "Exists", "effect": "NoSchedule"}] if gpus else [],
            "volumes": [{"name": "config", "configMap": {"name": f"{owner_name}-config"}},
                        {"name": "logs", "emptyDir": {}}],
        }
        self.ips = (node_ip, f"10.{rng.randrange(64, 128)}.{rng.randrange(256)}.{rng.randrange(1, 255)}")
        self._parts = None
        self._status = {}
        self._frames = {}

    @property
    def name(self) -> str:
        return self.metadata["name"]

    def pod(self, rv: int, phase: str, ready: bool, restarts: int) -> dict:
        return {"apiVersion": "v1", "kind": "Pod", "metadata": {**self.metadata, "resourceVersion": str(rv)},
                "spec": self.spec, "status": _pod_status(phase, ready, restarts, *self.ips, self.image)}

    def encode(self, rv: int, phase: str, ready: bool, restarts: int) -> bytes:
        if self._parts is None:
            meta = _encode(self.metadata).encode()
            self._parts = (b'{"apiVersion":"v1","kind":"Pod","metadata":' + meta[:-1] + b',"resourceVersion":"',
                           b'"},"spec":' + _encode(self.spec).encode() + b',"status":')
        head, middle = self._parts
        # the status at (phase, ready) is serialized once, around its restart count
        parts = self._status.get((phase, ready))
        if parts is None:
            text = _encode(_pod_status(phase, ready, _MARK_COUNT, *self.ips, self.image)).encode()
            before, after = text.split(_RESTARTS_MARK)
            parts = self._status[phase, ready] = (before + b'"restartCount":', after)
        before, after = parts
        return b"%s%d%s%s%d%s}" % (head, rv, middle, before, restarts, after)

    def frame(self, kind: str, rv: int, phase: str, ready: bool, restarts: int) -> bytes:
        """The WATCH frame of the pod at a state, ``{"type": kind, "object":
        encode()}`` and a newline, serialized once for (type, phase, ready)
        around its resourceVersion and restart count."""
        parts = self._frames.get((kind, phase, ready))
        if parts is None:
            text = b'{"type":"%s","object":%s}\n' % (kind.encode(), self.encode(_MARK_RV, phase, ready, _MARK_COUNT))
            head, rest = text.split(_RV_MARK)
            middle, tail = rest.split(_RESTARTS_MARK)
            parts = self._frames[kind, phase, ready] = (head + b'"resourceVersion":"',
                                                        b'"' + middle + b'"restartCount":', tail)
        head, middle, tail = parts
        return b"%s%d%s%d%s" % (head, rv, middle, restarts, tail)


class GpuCluster:
    """A seeded GPU cluster: the pods a LIST returns and the churn a WATCH then
    delivers, as steps ``(type, spec, phase, ready, restarts, rv)`` in
    resourceVersion order (``initial``, ``churn``).

    ``jobsets`` JobSets of ``workers`` GPU workers each in ``jobset_namespace``
    (``nvidia.com/gpu: 8``, JobSet name, replicated-job name and pod index
    labels), listed Pending; the churn takes each to Running, then Ready.
    ``failures`` JobSets lose one Ready worker: Failed, DELETED, and a
    replacement ADDED that goes Running and Ready. The rest of the pods are
    services without GPUs over the four watched namespaces, ``batch_share``
    of all pods in ``batch`` (which the watcher does not watch; 1% of those
    request GPUs), and the rest of the churn is MODIFIED status churn
    (restarts, readiness flips) on pods without GPUs. ``down_deletions`` are
    GPU workers of healthy JobSets to delete while the watcher is down.

    The node churn (``node_steps``, from its own seeded stream): at a third
    of the pod churn the nodes of ``node_flips`` workers of healthy JobSets go
    ``Ready=False`` and the node of one more healthy JobSet's worker is
    deleted; at two thirds the flipped nodes come back ``Ready``. Each step is
    ``(position, type, node, ready)``: the node event lands before
    ``churn[position]``. ``namespaces`` are the watched namespaces the
    services spread over.

    With ``listed_ready`` the workers are listed Running and Ready, and the
    churn holds no worker events (``failures`` must be 0): the steady
    cluster that :meth:`open_churn` churns."""

    node = staticmethod(node)

    def __init__(self, seed: int = 0, *, nodes: int = 2048, pods: int = 50000, jobsets: int = 256,
                 workers: int = 8, churn: int = 60000, failures: int = 32, batch_share: float = 0.10,
                 down_deletions: int = 16, jobset_namespace: str = "production",
                 namespaces=WATCHED_NAMESPACES, node_flips: int = 16, listed_ready: bool = False):
        if listed_ready and failures:
            raise ValueError("a cluster listed Ready has no failed JobSets")
        rng = random.Random(seed)
        self.nodes = nodes
        self._node_ips = [f"172.16.{i // 250}.{i % 250 + 1}" for i in range(nodes)]
        state = {}  # uid -> [phase, ready, restarts]
        specs = []

        def new_pod(name, namespace, gpus, labels, owner_kind, owner_name, phase, ready, node=None):
            spec = self._pod(rng, len(state), name, namespace, gpus, labels, owner_kind, owner_name, node)
            state[spec.uid] = [phase, ready, 0]
            return spec

        jobset_workers = {}
        for j in range(jobsets):
            js = f"train-{j:03d}"
            members = [new_pod(f"{js}-workers-0-{w}-{rng.getrandbits(20):05x}", jobset_namespace, 8,
                               {JOBSET_LABEL: js, REPLICATED_LABEL: "workers", INDEX_LABEL: str(w),
                                "batch.kubernetes.io/job-name": f"{js}-workers-0"},
                               "Job", f"{js}-workers-0", *(("Running", True) if listed_ready else ("Pending", False)),
                               node=j * workers + w)
                       for w in range(workers)]
            jobset_workers[members[0].jobset] = members
            specs.extend(members)
        n_batch = int(round(batch_share * pods))
        for i in range(pods - jobsets * workers):
            if i < n_batch:
                ns, gpus = UNWATCHED_NAMESPACE, (8 if i % 100 == 0 else 0)
            else:
                ns, gpus = namespaces[i % len(namespaces)], 0
            app = f"svc-{i % 997:03d}"
            specs.append(new_pod(f"{app}-{rng.getrandbits(40):010x}", ns, gpus,
                                 {"app": app, "pod-template-hash": "7d4b9c"}, "ReplicaSet", f"{app}-7d4b9c",
                                 "Running", True))
        self.initial = [("ADDED", spec, *state[spec.uid], rv) for rv, spec in enumerate(specs, start=1)]
        self.list_rv = len(specs)
        self._jobset_workers = jobset_workers

        # per-pod sequences of (spec, type, phase, ready); None = status churn
        sequences = []
        self.failed_jobsets = sorted(rng.sample(sorted(jobset_workers), failures))
        for key, members in jobset_workers.items():
            fail = rng.randrange(workers) if key in self.failed_jobsets else None
            for w, spec in enumerate(members):
                if listed_ready:
                    continue
                seq = [(spec, "MODIFIED", "Running", False), (spec, "MODIFIED", "Running", True)]
                if w == fail:
                    labels = spec.metadata["labels"]
                    replacement = new_pod(f"{labels[JOBSET_LABEL]}-workers-0-{w}-{rng.getrandbits(20):05x}",
                                          jobset_namespace, 8, labels, "Job", f"{labels[JOBSET_LABEL]}-workers-0",
                                          "Pending", False, node=int(spec.spec["nodeName"][-4:]))
                    seq += [(spec, "MODIFIED", "Failed", False), (spec, "DELETED", "Failed", False),
                            (replacement, "ADDED", "Pending", False), (replacement, "MODIFIED", "Running", True)]
                sequences.append(seq)
        plain = [s for s in specs if not s.gpus]
        remaining = churn - sum(len(s) for s in sequences)
        if remaining < 0:
            raise ValueError(f"churn={churn} is below the {churn - remaining} GPU worker events")
        per_pod = {}
        for _ in range(remaining):
            spec = plain[rng.randrange(len(plain))]
            per_pod[spec.uid] = (spec, per_pod.get(spec.uid, (spec, 0))[1] + 1)
        sequences.extend([(spec, "MODIFIED", None, None)] * k for spec, k in per_pod.values())
        timed = []
        for n, seq in enumerate(sequences):
            times = sorted(rng.random() for _ in seq)
            timed.extend((t, n, step) for t, step in zip(times, seq))
        timed.sort(key=lambda item: item[:2])
        self.churn = []
        for rv, (_, _, (spec, kind, phase, ready)) in enumerate(timed, start=self.list_rv + 1):
            st = state[spec.uid]
            if phase is None:  # status churn: a restart or a readiness flip
                if rng.random() < 0.5:
                    st[2] += 1
                else:
                    st[1] = not st[1]
            else:
                st[0], st[1] = phase, ready
            self.churn.append((kind, spec, *st, rv))
        self.last_rv = self.list_rv + len(self.churn)
        healthy = [m for key, members in jobset_workers.items() if key not in self.failed_jobsets for m in members]
        self.down_deletions = [(s.namespace, s.name, s.uid) for s in rng.sample(healthy, down_deletions)]
        # the node churn: one worker's node in each of node_flips + 1 healthy
        # JobSets (one JobSet a node: every JobSet's workers sit on their own)
        node_rng = random.Random(seed + 1)
        healthy_sets = sorted(k for k in jobset_workers if k not in self.failed_jobsets)
        picked = [node_rng.choice(jobset_workers[k]).spec["nodeName"]
                  for k in node_rng.sample(healthy_sets, node_flips + 1)]
        self.flipped_nodes, self.deleted_node = sorted(picked[:-1]), picked[-1]
        first, second = len(self.churn) // 3, 2 * len(self.churn) // 3
        self.node_steps = ([(first, "MODIFIED", n, False) for n in self.flipped_nodes]
                           + [(first, "DELETED", self.deleted_node, None)]
                           + [(second, "MODIFIED", n, True) for n in self.flipped_nodes])

    def _pod(self, rng, n: int, name, namespace, gpus, labels, owner_kind, owner_name, node=None) -> _PodSpec:
        """The ``n``-th pod made: on ``node`` (an index), else on a node drawn."""
        i = rng.randrange(self.nodes) if node is None else node % self.nodes
        return _PodSpec(rng, name=name, namespace=namespace, uid=f"uid-{n:06d}-{rng.getrandbits(32):08x}",
                        node=f"gpu-node-{i:04d}", node_ip=self._node_ips[i], gpus=gpus, labels=labels,
                        owner_kind=owner_kind, owner_name=owner_name)

    def node_names(self):
        """Every node of the cluster: the GPU nodes, then ``CPU_NODES`` nodes
        without GPUs (the watcher's node selector leaves them out)."""
        return [f"gpu-node-{i:04d}" for i in range(self.nodes)] + [f"cpu-node-{i}" for i in range(CPU_NODES)]

    @staticmethod
    def pods(steps):
        """The steps as ``(type, pod dict)`` pairs."""
        return [(kind, spec.pod(rv, phase, ready, restarts)) for kind, spec, phase, ready, restarts, rv in steps]

    @staticmethod
    def facts(steps):
        """What the fold reads of each step, as ``facts_of`` reads it of a pod."""
        return [(kind, spec.namespace, spec.name, spec.uid, spec.gpus, spec.jobset, phase,
                 (("main", ready, restarts), ("log-agent", ready, 0)), spec.spec["nodeName"])
                for kind, spec, phase, ready, restarts, _ in steps]


    def open_churn(self, seed: int, gpu_share: float = 0.01, gap: int = EPISODE_GAP):
        """The endless churn of a cluster built with ``listed_ready``: steps
        ``(type, spec, phase, ready, restarts, rv)`` from ``list_rv + 1`` on,
        the same for a seed whatever the rate they are offered at.

        A share ``gpu_share`` of the steps belong to GPU worker episodes. An
        episode starts at a Running and Ready worker of a JobSet with no
        episode open, with a terminal event drawn evenly from ``TERMINALS``:
        a MODIFIED to Failed or Succeeded, which the pod's DELETED follows, or
        a DELETED of the running pod (a preemption). Its replacement, on the
        same node, is then ADDED (Pending), goes Running, then Ready, and the
        JobSet is free for another episode. Each step of an episode lands 1 to
        ``2 * gap`` positions after the one before it. Every other step is a
        MODIFIED of a pod without GPUs or in ``batch``: a restart or a
        readiness flip, evenly."""
        rng = random.Random(f"open-churn/{seed}")
        state = {spec.uid: [phase, ready, restarts] for _, spec, phase, ready, restarts, _ in self.initial}
        routine = [spec for _, spec, *_ in self.initial if not spec.gpus or spec.namespace == UNWATCHED_NAMESPACE]
        members = {key: list(workers) for key, workers in self._jobset_workers.items()}
        idle = sorted(members)  # JobSets with no episode open
        pending = []  # (position due, episode number, key, worker, [steps left])
        steps_per_episode = sum(4 if t == "DELETED" else 5 for t in TERMINALS) / len(TERMINALS)
        start = gpu_share / steps_per_episode
        made = len(state)
        for rv in itertools.count(self.list_rv + 1):
            position = rv - self.list_rv
            if pending and pending[0][0] <= position:
                _, n, key, worker, steps = heapq.heappop(pending)
            elif idle and rng.random() < start:
                key = idle.pop(rng.randrange(len(idle)))
                worker = members[key][rng.randrange(len(members[key]))]
                terminal = TERMINALS[rng.randrange(len(TERMINALS))]
                labels = worker.metadata["labels"]
                replacement = self._pod(rng, made, f"{labels[JOBSET_LABEL]}-workers-0-{labels[INDEX_LABEL]}-"
                                        f"{rng.getrandbits(20):05x}", worker.namespace, worker.gpus, labels, "Job",
                                        worker.metadata["ownerReferences"][0]["name"],
                                        node=int(worker.spec["nodeName"][-4:]))
                made += 1
                state[replacement.uid] = ["Pending", False, 0]
                ended = [] if terminal == "DELETED" else [(worker, "MODIFIED", terminal, False)]
                steps = ended + [(worker, "DELETED", None, None), (replacement, "ADDED", "Pending", False),
                                 (replacement, "MODIFIED", "Running", False), (replacement, "MODIFIED", "Running", True)]
                n = made
            else:
                spec = routine[rng.randrange(len(routine))]
                st = state[spec.uid]
                if rng.random() < 0.5:
                    st[2] += 1
                else:
                    st[1] = not st[1]
                yield "MODIFIED", spec, *st, rv
                continue
            spec, kind, phase, ready = steps.pop(0)
            st = state[spec.uid]
            if phase is not None:
                st[0], st[1] = phase, ready
            if steps:
                heapq.heappush(pending, (position + rng.randint(1, 2 * gap), n, key, worker, steps))
            elif kind == "MODIFIED":  # the replacement is Ready: the episode is over
                members[key][members[key].index(worker)] = spec
                idle.append(key)
            yield kind, spec, *st, rv
