"""Replays a test module of the JAX package against the port.

:func:`replay` reads a ``tests/test_*.py`` file, points its imports of
``k8s_watcher_tpu`` at ``k8s_watcher_tpu_torch`` (with extra textual
``rewrites`` where a name differs), and executes it as a new module. A port
test file binds the replayed test classes into its own namespace, so pytest
collects each of the reference's scenarios a second time, now run through
the port: the reference's own assertions hold the port to the reference's
behaviour. Modules named in ``keep`` stay the JAX package's (data builders
the port has no copy of). This file holds no tests.
"""

import re
import sys
import types
from pathlib import Path
from typing import Iterable, Optional, Sequence, Tuple

TESTS = Path(__file__).resolve().parent


def replay(filename: str, *, keep: Iterable[str] = (), rewrites: Sequence[Tuple[str, str]] = ()) -> types.ModuleType:
    source = (TESTS / filename).read_text()
    for old, new in rewrites:
        if old not in source:
            raise AssertionError(f"{filename}: rewrite target {old!r} not found")
        source = source.replace(old, new)
    kept = tuple(keep)

    def port_name(match: re.Match) -> str:
        module = match.group(0)
        if any(module == k or module.startswith(k + ".") for k in kept):
            return module
        return "k8s_watcher_tpu_torch" + module[len("k8s_watcher_tpu"):]

    source = re.sub(r"\bk8s_watcher_tpu(?!\w)(?:\.\w+)*", port_name, source)
    name = f"replayed_{Path(filename).stem}"
    module = types.ModuleType(name)
    module.__file__ = str(TESTS / filename)
    sys.modules[name] = module
    exec(compile(source, str(TESTS / filename), "exec"), module.__dict__)
    return module


def replayed_tests(module: types.ModuleType, only: Optional[Iterable[str]] = None,
                   leave_out: Iterable[str] = ()) -> dict:
    """The module's test classes and functions, renamed ``TestPort<name>`` and
    ``test_port_<name>`` so their node ids say which package ran them.
    ``only`` picks classes by name; ``leave_out`` names the ``Class.method``s
    and module-level ``test_`` functions of planes the port does not carry,
    which the replay drops."""
    out = {}
    dropped: dict = {}
    for entry in leave_out:
        cls_name, _, method = entry.partition(".")
        dropped.setdefault(cls_name, []).append(method)
    for name, obj in vars(module).items():
        if (only is not None and name not in only) or dropped.get(name) == [""]:
            continue
        if isinstance(obj, type) and name.startswith("Test"):
            if name in dropped:
                # a subclass that hides the dropped methods from collection
                obj = type(name, (obj,), {m: None for m in dropped[name]})
            out[f"TestPort{name[4:]}"] = obj
        elif isinstance(obj, types.FunctionType) and name.startswith("test_"):
            out[f"test_port_{name[5:]}"] = obj
    return out


def __getattr__(name: str):
    """``CpuWatcherApp``: the port's ``WatcherApp`` with its probe agent and
    analytics on the CPU unless the caller names a device (the port runs
    them on a GPU by default), for replayed tests that build an app the JAX
    package's way. Made on first use, so importing this helper imports no
    torch."""
    if name != "CpuWatcherApp":
        raise AttributeError(name)
    from k8s_watcher_tpu_torch.app import WatcherApp

    class CpuWatcherApp(WatcherApp):
        def __init__(self, *args, **kwargs):
            kwargs.setdefault("device", "cpu")
            super().__init__(*args, **kwargs)

    globals()[name] = CpuWatcherApp
    return CpuWatcherApp
