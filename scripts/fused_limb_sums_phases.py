"""Where the time of the fused_limb_sums kernel goes, on one CUDA card.

    python3 scripts/fused_limb_sums_phases.py [--call q1 q9 dashboard lineitem]
        [--sf 1.0] [--seed 0] [--repeats 5] [--against DIR ...] [--out PATH]

For each chosen call it takes the lanes the main path hands the kernel:
`q1` runs TPC-H q1 once through run_query (the lone entry
fused_limb_sums: n 6.0M at SF1, G 16, 39 requests), `q9` the committed
corpus's q9 at SF1 as chip_smoke.py's phase_corpus runs it (the lanes
of its last join, G 32); `dashboard` and
`lineitem` run one batch of 64 of scripts/batching_phase.py's dashboard
and lineitem (`batch`) families through BatchingExecutor.bench_dispatch
(the batched entry fused_limb_sums_batched: 1.5M `orders` rows, G 8;
6.0M `lineitem` rows, G 1). Then it builds
presto_tpu_torch/ops/csrc/fused_limb_sums.cu twice more, with
-DFUSED_LIMB_SUMS_PHASES (phase clocks in the chunk loop of block (0,
0)), and the same file of every `--against` checkout (DIR: an unpacked
`git archive` of another commit, in a git-ignored directory), plain and
clocked. Every build is held to the plain version on the call's lanes,
bit for bit. Then, per call:

  * the kernel's device time (torch.profiler, median of --repeats
    launches) of each build in turns: DIR, this, this, DIR for each DIR;
  * block (0, 0)'s clock cycles per chunk in each phase (issuing the
    next chunk's copies, waiting for this chunk's copies and the
    barrier, the limb split and its barrier, the sums), of this build
    and of each DIR's, and for this build what the entry chose (members
    a tile, tiles, items a warp, work items, shared memory, blocks an
    SM, chunk ranges, classes of shared columns).

Prints one JSON object per call and the card's name and power limit;
--out writes them all. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

PHASES = ("issue copies", "wait copies", "split", "sums")
CALLS = ("q1", "q9", "dashboard", "lineitem")
BATCH = 64


def build(src, name, defines=()):
    """csrc `src` compiled into build/<name>.so, its C entries bound as in
    the package's own library (and the phase clocks' and the launch
    plan's where the build has them)."""
    from presto_tpu_torch.ops import kernels as K
    os.makedirs(K._BUILD, exist_ok=True)
    so = os.path.join(K._BUILD, name + ".so")
    proc = subprocess.run([K._nvcc(), *K._NVCC_FLAGS, *defines, "-o", so,
                           src], capture_output=True, text=True)
    with open(so[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    for fn, argtypes in K._SIGNATURES["fused_limb_sums"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    for fn, argtypes in (("fused_limb_sums_phases",
                          [ctypes.c_void_p, ctypes.c_int]),
                         ("fused_limb_sums_last_plan", [ctypes.c_void_p])):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def q1_call(C, sf):
    """The lanes q1 hands fused_limb_sums: (ids, sources, requests,
    groups, None)."""
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.ops import kernels as K
    calls, fused = [], K.fused_limb_sums

    def recording(ids, sources, requests, groups, **kw):
        if not calls:
            calls.append((ids, sources, requests, groups, None))
        return fused(ids, sources, requests, groups, **kw)

    K.fused_limb_sums = recording
    try:
        run_query(C.as_built(C.q1_plan(), sf), sf=sf, prepared=True)
    finally:
        K.fused_limb_sums = fused
    return calls[0]


def q9_call(C):
    """The lanes the corpus's q9 hands fused_limb_sums on the path that
    returns its rows (chip_smoke.phase_query, as phase_corpus runs it)."""
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.queries import load_corpus
    entry = load_corpus()[C.SECOND_G_QUERY]
    calls = []
    C.phase_query(C.SECOND_G_QUERY, lambda: from_json(entry["plan"]),
                  lambda _t: entry["rows"], C._scanned_columns(entry["plan"]),
                  entry["sf"], rows=C._exact_rows, fused_calls=calls)
    return (*calls[0], None)


def batch_call(C, family, seed):
    """The lanes a batch of 64 of `family` (scripts/batching_phase.py's
    templates and keys) hands fused_limb_sums_batched."""
    import numpy as np
    import batching_phase as BP
    from presto_tpu_torch.exec.batching import BatchingExecutor
    from presto_tpu_torch.ops import kernels as K
    oracles = BP.Oracles(C)
    keys = BP._keys(np.random.default_rng(seed), oracles)[family]
    template = oracles.families()[family][0]
    texts = [template.format(k) for k in keys[:BATCH]]
    real, recording, first = BP._first_batched_call()
    K.fused_limb_sums_batched = recording
    try:
        BatchingExecutor().bench_dispatch(texts, sf=BP.SF, device=BP.DEVICE)
    finally:
        K.fused_limb_sums_batched = real
    return first[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--call", nargs="+", choices=CALLS, default=["q1"])
    ap.add_argument("--sf", type=float, default=1.0, help="q1's scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--against", nargs="*", default=[],
                    help="checkout roots whose fused_limb_sums.cu to time "
                         "beside this one")
    ap.add_argument("--out", help="also write the reports here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fused_limb_sums_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from presto_tpu_torch.ops import kernels as K
    C.install_host_cache()
    own = K._library("fused_limb_sums")
    src = os.path.join(K._CSRC, "fused_limb_sums.cu")
    sides = {"this": (own, build(src, "fused_limb_sums-phases",
                                 ["-DFUSED_LIMB_SUMS_PHASES"]))}
    for i, d in enumerate(args.against):
        other = os.path.join(d, "presto_tpu_torch", "ops", "csrc",
                             "fused_limb_sums.cu")
        sides[d] = (build(other, f"fused_limb_sums-against-{i}"),
                    build(other, f"fused_limb_sums-against-{i}-phases",
                          ["-DFUSED_LIMB_SUMS_PHASES"]))
    gpu = C._run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    clock = C._run(["nvidia-smi", "--query-gpu=clocks.sm",
                    "--format=csv,noheader"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def with_lib(lib, fn):
        K._libs["fused_limb_sums"] = lib
        try:
            return fn()
        finally:
            K._libs["fused_limb_sums"] = own

    reports = []
    for what in args.call:
        if what == "q1":
            ids, sources, reqs, groups, batch = q1_call(C, args.sf)
        elif what == "q9":
            ids, sources, reqs, groups, batch = q9_call(C)
        else:
            ids, sources, reqs, groups, batch = batch_call(
                C, "dashboard" if what == "dashboard" else "batch", args.seed)
        if batch is None:
            def call():
                return K.fused_limb_sums(ids, sources, reqs, groups)
            want = K.fused_limb_sums_reference(ids, sources, reqs, groups)
        else:
            def call():
                return K.fused_limb_sums_batched(ids, sources, reqs, groups,
                                                 batch)
            want = K.fused_limb_sums_batched_reference(ids, sources, reqs,
                                                       groups, batch)
        for side, libs in sides.items():
            for lib in libs:
                if not torch.equal(with_lib(lib, call), want):
                    raise AssertionError(f"{what}: the {side} build "
                                         f"{lib._name} disagrees with the "
                                         "plain version")
        del want
        # device time in turns: DIR, this, this, DIR for each DIR
        order = []
        for d in args.against:
            order += [d, "this", "this", d]
        order = order or ["this"]
        turns = [(side, with_lib(sides[side][0], lambda: C.device_ms(
            call, "fused_limb_sums_kernel", args.repeats)))
            for side in order]
        device_ms = {side: statistics.mean(ms for s, ms in turns
                                           if s == side)
                     for side in dict.fromkeys(order)}
        n = ids.shape[-1]
        chunks = -(-n // 1024)
        plan = None
        cycles = {}
        for side, (_plain, clocked) in sides.items():
            def clocked_runs():
                clocked.fused_limb_sums_phases(None, 1)
                for _ in range(args.repeats):
                    call()
                torch.cuda.synchronize()
            with_lib(clocked, clocked_runs)
            got = (ctypes.c_ulonglong * 4)()
            if clocked.fused_limb_sums_phases(got, 0) != 0:
                raise RuntimeError("reading the phase clocks failed")
            if hasattr(clocked, "fused_limb_sums_last_plan"):
                p = (ctypes.c_int * 8)()
                clocked.fused_limb_sums_last_plan(p)
                if side == "this":
                    plan = dict(zip(("members", "tiles", "items_a_warp",
                                     "items", "smem", "blocks_per_sm",
                                     "chunk_ranges", "classes"), list(p)))
                ranges, members = p[6], p[0]
            else:  # the member grid axis: one block an SM, shared by B
                ranges = max(1, sms // (batch or 1))
                members = 1
            per_block = -(-chunks // min(ranges, chunks))
            cycles[side] = {
                "block0_chunks": per_block, "block0_members": members,
                "cycles_per_chunk": {
                    name: got[i] / (per_block * args.repeats)
                    for i, name in enumerate(PHASES)}}
        report = {
            "call": what, "gpu": gpu, "sm_clock": clock,
            "device_ms": device_ms, "turns": turns, "plan": plan,
            "phases": cycles, "B": batch or 1, "rows": n, "groups": groups,
            "requests": len(reqs), "sources": len(sources)}
        print(json.dumps(report), flush=True)
        reports.append(report)
        del ids, sources, reqs
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
