"""What the watcher notifies, as a plain fold of the watch events it was
delivered, and how the notifications a sink received are held to it.

:func:`fold_production` follows the semantics of the JAX package's
``pipeline/`` and ``slices/tracker.py`` (the port's are their twins): the
namespace filter, the GPU resource filter (``nvidia.com/gpu`` requested by a
container), the critical gate of ``production`` (``alerts.critical_events_only``:
a significant change notifies only when the pod is DELETED or reaches
Failed or Succeeded), and each JobSet's slice phase. Where it departs:

- a JobSet's members are keyed by its namespace, JobSet name and replicated
  job (``namespace/name/job``); GPU JobSets carry no topology label, so no
  slice has an expected worker count, and a slice is Ready when every member
  it holds is Running and ready, as the tracker rules for such slices;
- a pod's readiness is every container's ``ready``; the Ready condition,
  which the pipeline falls back to for a pod with no container statuses, is
  never needed here (every pod served has them);
- the node plane is folded only as far as ``node_steps`` give node events;
- health, SLO, probe and remediation payloads are not folded: the health
  detector's peer scoring is held to the JAX package by the port's own tests
  (``tests/test_torch_health.py``).

Plain Python: nothing here imports the port, JAX or the JAX package.
"""

from __future__ import annotations

from portbench.traffic.cluster import GPU_KEY, JOBSET_LABEL, REPLICATED_LABEL, WATCHED_NAMESPACES

POD_EVENTS = ("ADDED", "MODIFIED", "DELETED")
NODE_EVENTS = ("NODE_CONDITION_CHANGE", "NODE_DELETED")


def facts_of(kind: str, pod: dict) -> tuple:
    """``(type, namespace, name, uid, GPUs requested, JobSet slice key or None,
    phase, container (name, ready, restarts), node)`` of one watch event's
    pod."""
    meta = pod.get("metadata") or {}
    labels = meta.get("labels") or {}
    gpus = sum(int((c.get("resources") or {}).get("requests", {}).get(GPU_KEY, 0))
               for c in (pod.get("spec") or {}).get("containers") or [])
    jobset = f"{meta.get('namespace')}/{labels[JOBSET_LABEL]}/{labels[REPLICATED_LABEL]}" \
        if JOBSET_LABEL in labels else None
    ready = tuple((cs.get("name", ""), bool(cs.get("ready", False)), int(cs.get("restartCount", 0) or 0))
                  for cs in (pod.get("status") or {}).get("containerStatuses") or [])
    return (kind, meta.get("namespace", ""), meta.get("name", ""), meta.get("uid", ""), gpus, jobset,
            (pod.get("status") or {}).get("phase", "Unknown"), ready, (pod.get("spec") or {}).get("nodeName"))


def _slice_phase(members: dict, ever_ready: bool, had_members: bool, down=frozenset()) -> str:
    """A slice's phase from its members' (phase, ready, node), with no
    expected worker count (GPU JobSets carry no topology): a member that has
    not succeeded on a node in ``down`` (NotReady, or deleted) degrades it."""
    if not members:
        return "Terminated" if had_members else "Forming"
    phases = [phase for phase, _, _ in members.values()]
    if any(p in ("Failed", "Unknown") for p in phases):
        return "Degraded"
    if any(node in down and p != "Succeeded" for p, _, node in members.values()):
        return "Degraded"
    if all(p == "Succeeded" for p in phases):
        return "Completed"
    if all(p == "Running" and ready for p, ready, _ in members.values()):
        return "Ready"
    return "Degraded" if ever_ready else "Forming"


def fold_production(facts, namespaces=WATCHED_NAMESPACES, node_steps=(), critical=True, node_caused=None,
                    sent=None):
    """The plain reference of what the watcher notifies, over ``facts`` in
    watch order: the namespace filter, the GPU resource filter, and (with
    ``critical``, the ``production`` rules) the critical gate (DELETED or a
    terminal phase) on a significant change (first sighting, phase or
    container-status change, deletion); ``critical=False`` is the
    ``staging`` rules, which notify every significant change. And each
    JobSet's slice phase, with the node events of ``node_steps`` (``(position,
    type, node, ready)``, folded before ``facts[position]``): a NotReady or
    deleted node degrades every slice with a member on it that has not
    succeeded, and a node back Ready restores it.

    Returns ``(last, transitions)``: the last pod notification per uid as
    ``(event_type, phase, namespace, name)``, and each slice key's phase
    transitions as ``(from, to)`` pairs. The transitions a node event causes
    are appended to ``node_caused`` as ``(key, from, to)``, and every
    notification, in the order the watcher makes them, to ``sent`` as
    ``(key, what is compared of it)`` (:func:`pod_item`, :func:`slice_item`)."""
    last, seen, slices, transitions = {}, {}, {}, {}
    down = set()
    pending = sorted(node_steps, key=lambda step: step[0])

    def recompute(key, st, caused=None):
        new = _slice_phase(st["members"], st["ever_ready"], st["had"], down)
        st["ever_ready"] = st["ever_ready"] or new == "Ready"
        if new != st["phase"]:
            transitions.setdefault(key, []).append((st["phase"], new))
            if sent is not None:
                sent.append((key, slice_item(key, st["phase"], new)))
            if caused is not None:
                caused.append((key, st["phase"], new))
            st["phase"] = new

    def node_event(kind, node, ready):
        if ready:
            down.discard(node)
        else:
            down.add(node)
        for key, st in slices.items():
            if any(n == node for _, _, n in st["members"].values()):
                recompute(key, st, node_caused)

    for i, (kind, ns, name, uid, gpus, jobset, phase, ready, node) in enumerate(facts):
        while pending and pending[0][0] <= i:
            node_event(*pending.pop(0)[1:])
        if (namespaces and ns not in namespaces) or not gpus:
            continue
        prev = seen.pop(uid, None) if kind == "DELETED" else seen.get(uid)
        if kind != "DELETED":
            seen[uid] = (phase, ready)
        if (kind == "DELETED" or prev != (phase, ready)) and (
                not critical or kind == "DELETED" or phase in ("Failed", "Succeeded")):
            last[uid] = (kind, phase, ns, name)
            if sent is not None:
                sent.append((uid, pod_item(kind, uid, ns, name, phase, ready, node, gpus)))
        if jobset is None:
            continue
        st = slices.setdefault(jobset, {"members": {}, "phase": "Forming", "ever_ready": False, "had": False})
        if kind == "DELETED":
            st["members"].pop(uid, None)
        else:
            st["members"][uid] = (phase, bool(ready) and all(r for _, r, _ in ready), node)
        st["had"] = st["had"] or bool(st["members"])
        recompute(jobset, st)
    for step in pending:
        node_event(*step[1:])
    return last, transitions


def pod_item(kind, uid, namespace, name, phase, containers, node, gpus) -> tuple:
    """What is compared of a pod notification: its type, identity, phase,
    each container's (name, ready, restarts), node and GPU count."""
    return ("pod", kind, uid, namespace, name, phase, tuple(containers), node, gpus)


def slice_item(key, phase_from, phase_to) -> tuple:
    return ("slice", key, phase_from, phase_to)


def received_item(payload: dict):
    """``(key, item)`` of a POSTed payload the fold answers for (a pod's, a
    slice's, a node's), read as :func:`pod_item` and :func:`slice_item` have
    it; None for the probe's, health's and remediation's."""
    kind = payload.get("event_type")
    if kind in POD_EVENTS:
        status = payload.get("status") or {}
        containers = [(c.get("name"), bool(c.get("ready")), int(c.get("restart_count") or 0))
                      for c in status.get("container_statuses") or ()]
        uid = payload.get("uid")
        return uid, pod_item(kind, uid, payload.get("namespace"), payload.get("name"), status.get("phase"),
                             containers, (payload.get("spec") or {}).get("node_name"),
                             (payload.get("tpu") or {}).get("chips"))
    if kind == "SLICE_PHASE_CHANGE":
        moved = payload.get("phase_transition") or {}
        return payload.get("slice"), slice_item(payload.get("slice"), moved.get("from"), moved.get("to"))
    if kind in NODE_EVENTS:
        return payload.get("node"), ("node", kind, payload.get("node"), payload.get("ready"))
    return None


def _common_order(a: list, b: list) -> int:
    """The length of the longest common subsequence of ``a`` and ``b``."""
    row = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b):
            prev, row[j + 1] = row[j + 1], prev + 1 if x == y else max(row[j + 1], row[j])
    return row[-1]


def compare(expected, received) -> dict:
    """Each key's notifications, as the fold calls for them (``expected``)
    and as the sink received them (``received``), both lists of ``(key,
    item)`` in order:

    - ``notifications_lost``: items the fold calls for that the sink never
      received (as a multiset, per key);
    - ``payloads_wrong``: items received that the fold does not call for: an
      altered payload, a duplicate, a stray;
    - ``out_of_order``: of the items both hold, per key, those that must move
      for the sink's order to be the fold's (their count less the longest
      common subsequence)."""
    want, got = {}, {}
    for key, item in expected:
        want.setdefault(key, []).append(item)
    for key, item in received:
        got.setdefault(key, []).append(item)
    lost = wrong = moved = 0
    for key in want.keys() | got.keys():
        w, g = want.get(key, []), got.get(key, [])
        left = list(g)
        common_w = []
        for item in w:
            if item in left:
                left.remove(item)
                common_w.append(item)
            else:
                lost += 1
        wrong += len(left)
        pool = list(common_w)
        common_g = []
        for item in g:
            if item in pool:
                pool.remove(item)
                common_g.append(item)
        moved += len(common_w) - _common_order(common_w, common_g)
    return {"payloads_wrong": wrong, "notifications_lost": lost, "out_of_order": moved}
