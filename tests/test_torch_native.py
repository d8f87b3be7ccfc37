"""The port's native watch-frame prefilter held against the JAX package's.

``tests/test_native.py`` is replayed through the port, whose ``fastscan.cpp``
builds with ``g++`` into its own cache (the scanner's verdicts, every
chunk-split boundary, the crc32 foreign-shard skip, the degrade to the Python
scanner with one INFO line or a pinned WARNING, the prefiltered watch over
HTTP). Side by side, seeded watch frames (numpy RNG) go through the JAX
package's native scanner, the port's native scanner and the port's Python
scanner: per-frame ``FrameScan``s and per-chunk verdicts at random splits,
with and without a shard, must be equal, and the skipped foreign-shard frames
are exactly those whose uid's ``zlib.crc32`` names another shard.
"""

import json
import zlib

import numpy as np
import pytest

from k8s_watcher_tpu.native.build import build_fastscan as ref_build
from k8s_watcher_tpu.native.scanner import NativeFrameScanner as RefNative
from k8s_watcher_tpu.watch.fake import build_pod
from k8s_watcher_tpu_torch.native import build as port_build
from k8s_watcher_tpu_torch.native.scanner import NativeFrameScanner, PythonFrameScanner, make_scanner
from test_torch_replay import replay, replayed_tests

_native = replay("test_native.py", keep=("k8s_watcher_tpu.k8s.mock_server",))
native_scanner = _native.native_scanner  # the replayed tests' fixture
globals().update(replayed_tests(_native))

KEY = "nvidia.com/gpu"


@pytest.fixture(scope="module")
def scanners():
    ref_lib, port_lib = ref_build(), port_build.build_fastscan()
    assert ref_lib is not None and port_lib is not None, port_build.last_build_error()
    # the port builds its own copy into its own cache, never the JAX package's
    assert port_lib.parent.name == "_build" and port_lib.parent.parent.name == "k8s_watcher_tpu_torch"
    return {"ref": RefNative(KEY, ref_lib), "port": NativeFrameScanner(KEY, port_lib),
            "python": PythonFrameScanner(KEY)}


def frames(seed, n=900):
    """Seeded frames: pods with and without the key (in a request or only in
    a label), BOOKMARKs, ERRORs, escaped and missing resourceVersions, CRLF
    line ends, blank lines and multibyte names."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        roll = rng.random()
        rv = str(1000 + i)
        if roll < 0.80:
            gpus = int(rng.random() < 0.15) * 8
            pod = build_pod(f"p{i}-é✓" if rng.random() < 0.1 else f"p{i}", uid=f"uid-{seed}-{i}",
                            resource_version=rv, labels={"note": KEY} if rng.random() < 0.03 else None)
            if gpus:
                pod["spec"]["containers"][0]["resources"] = {"requests": {KEY: str(gpus)}}
            kind = ("ADDED", "MODIFIED", "DELETED")[int(rng.integers(3))]
            line = json.dumps({"type": kind, "object": pod}, ensure_ascii=False).encode()
        elif roll < 0.88:
            line = b'{"type":"BOOKMARK","object":{"metadata":{"resourceVersion":"%s"}}}' % rv.encode()
        elif roll < 0.91:
            line = b'{"type":"ERROR","object":{"code":410,"message":"gone"}}'
        elif roll < 0.94:
            line = b'{"type":"MODIFIED","object":{"metadata":{"resourceVersion":"e\\"%d"}}}' % i
        elif roll < 0.97:
            line = b'{"type":"MODIFIED","object":{"metadata":{"uid":"u%d"}}}' % i
        else:
            line = b""
        out.append(line + (b"\r\n" if rng.random() < 0.1 else b"\n"))
    return out


def verdicts(scanner, stream, cuts, shard):
    """From ``scan_chunk`` over ``stream`` cut at ``cuts``: per frame, in
    order, ``"skip"`` or the bytes to parse; the resume version of every
    skip-run's last frame; and the last tail. (Where a run of skips is split
    into records depends on the chunk and record caps, so only a run's last
    resume version is compared.)"""
    out, rvs, tail, prev = [], [], b"", 0
    for cut in list(cuts) + [len(stream)]:
        buf = tail + stream[prev:cut]
        prev = cut
        records, consumed = scanner.scan_chunk(buf, shard=shard)
        tail = buf[consumed:]
        for start, length, rv, count in records:
            if rv is None:
                if out and out[-1] == "skip":
                    rvs.append(last_rv)
                out.append(bytes(buf[start:start + length]))
            else:
                out.extend(["skip"] * count)
                last_rv = rv
    if out and out[-1] == "skip":
        rvs.append(last_rv)
    return out, rvs, tail


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_and_python_scanners_agree_frame_by_frame(scanners, seed):
    def fields(scan):  # the two packages' FrameScan classes differ
        return scan.type, scan.resource_version, scan.has_key, scan.uid, scan.skippable

    for line in frames(seed):
        raw = line.rstrip(b"\r\n")
        want = fields(scanners["ref"].scan(raw))
        assert fields(scanners["port"].scan(raw)) == want, raw[:120]
        assert fields(scanners["python"].scan(raw)) == want, raw[:120]


@pytest.mark.parametrize("seed, shard", [(3, None), (4, (0, 2)), (5, (3, 4)), (6, (1, 3))])
def test_chunk_verdicts_agree_at_random_splits(scanners, seed, shard):
    rng = np.random.default_rng(seed)
    stream = b"".join(frames(seed))
    cuts = sorted(int(c) for c in rng.integers(1, len(stream), size=400))
    want = verdicts(scanners["ref"], stream, cuts, shard)
    for name in ("port", "python"):
        assert verdicts(scanners[name], stream, cuts, shard) == want, name
    # one unsplit chunk gives the same per-frame verdicts and resume points
    assert verdicts(scanners["port"], stream, [], shard)[:2] == verdicts(scanners["ref"], stream, [], shard)[:2]
    assert verdicts(scanners["port"], stream, [], shard)[0] == want[0]
    if shard is None:
        return
    # the foreign-shard skip: a frame that carries the key and an
    # extractable uid is skipped iff crc32(uid) % n names another shard
    index, n = shard
    got = iter(want[0])
    checked = 0
    for line in frames(seed):
        raw = line.rstrip(b"\r\n")
        if not raw.strip():
            continue
        verdict = next(got)
        scan = scanners["python"].scan(raw)
        if scan.has_key and scan.uid is not None and scan.type in ("ADDED", "MODIFIED", "DELETED") \
                and scan.resource_version is not None:
            foreign = zlib.crc32(scan.uid.encode()) % n != index
            assert (verdict == "skip") == foreign, raw[:120]
            checked += 1
    assert checked > 20


def test_make_scanner_picks_the_native_scanner():
    assert isinstance(make_scanner(KEY, mode="auto"), NativeFrameScanner)
    assert isinstance(make_scanner(KEY, mode="native"), NativeFrameScanner)
    assert isinstance(make_scanner(KEY, mode="python"), PythonFrameScanner)
    assert make_scanner(KEY, mode="off") is None
