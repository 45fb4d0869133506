"""Where the time of the contains_bytes kernel goes, on one CUDA card.

    python3 scripts/contains_bytes_phases.py [--repeats 10] [--against DIR ...]

Stages the columns chip_smoke.py times (SF1 lineitem.comment with
'special' and with a word it never holds, SF10 part.type with 'PROMO',
and periodic rows of 'a' with the costliest needle) and, for each,
prints one JSON object:

* `device_ms`: the kernel's device time (torch.profiler, median);
* `cycles_per_tile`: block 0's clock cycles per tile in each phase of
  its tile loop (waiting for the tile's copies, issuing the copies two
  tiles ahead, storing the tile before's flags, the scan), from a
  second build of presto_tpu_torch/ops/csrc/contains_bytes.cu with
  -DCONTAINS_BYTES_PHASES, checked against the plain version first;
* with `--against DIR`, the device time of the contains_bytes.cu of
  the checkout at DIR (built the same way, bound to the same C entry),
  timed in turns with this checkout's on the same inputs: DIR, this,
  this, DIR, all builds of a case in one profiling window.

Ends with the card's name and power limit and the SM clock. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PHASES = ("wait copies", "issue copies", "store flags", "scan")


def build(src, name, defines=()):
    """csrc `src` compiled into build/<name>.so, its C entry
    contains_bytes_u8 bound as in the package's own library (the only
    function the wrapper calls on arguments it takes)."""
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
    lib.contains_bytes_u8.argtypes = \
        K._SIGNATURES["contains_bytes"]["contains_bytes_u8"]
    lib.contains_bytes_u8.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--against", nargs="*", default=[],
                    help="checkout roots whose contains_bytes.cu to time "
                         "beside this one")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("contains_bytes_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from presto_tpu_torch.ops import kernels as K

    own = K._library("contains_bytes")
    src = os.path.join(K._CSRC, "contains_bytes.cu")
    clocked = build(src, "contains_bytes-phases", ["-DCONTAINS_BYTES_PHASES"])
    clocked.contains_bytes_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocked.contains_bytes_phases.restype = ctypes.c_int
    others = [(d, build(os.path.join(d, "presto_tpu_torch", "ops", "csrc",
                                     "contains_bytes.cu"),
                        f"contains_bytes-against-{i}"))
              for i, d in enumerate(args.against)]

    cases = C.timed_contains_cases(np.random.default_rng(0))

    def with_lib(lib, fn):
        K._libs["contains_bytes"] = lib
        try:
            return fn()
        finally:
            K._libs["contains_bytes"] = own

    for what, col, needle in cases:
        n, w = col.chars.shape

        def call():
            return K.contains_bytes(col.chars, col.lengths, needle)

        want = K.contains_bytes_reference(col.chars, col.lengths, needle)
        for lib in [clocked] + [lib for _, lib in others]:
            if not torch.equal(with_lib(lib, call), want):
                raise AssertionError(f"{what} {needle!r}: a build disagrees "
                                     "with the plain version")
        # every build's device time in one profiling window, in turns:
        # this, then for each DIR: DIR, this, this, DIR
        turns = [("this", own)]
        for d, lib in others:
            turns += [(d, lib), ("this", own), ("this", own), (d, lib)]
        times = C.device_times(
            [lambda lib=lib: with_lib(lib, call) for _, lib in turns],
            "contains", args.repeats)
        report = {"case": f"{what} {needle.decode()!r}", "n": n, "W": w,
                  "bound_ms": (n * w + 5 * n) / C.HBM_BYTES_PER_S * 1e3,
                  "device_ms": times[0]}
        clocked.contains_bytes_phases(None, 1)
        with_lib(clocked, lambda: [call() for _ in range(args.repeats)])
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 5)()
        if clocked.contains_bytes_phases(cycles, 0) != 0:
            raise RuntimeError("reading the phase clocks failed")
        tiles = max(cycles[4], 1)
        report["block0_tiles_per_call"] = cycles[4] / args.repeats
        report["cycles_per_tile"] = {name: cycles[i] / tiles
                                     for i, name in enumerate(PHASES)}
        report["against"] = {}
        for i, (d, _) in enumerate(others):
            t = times[1 + 4 * i:5 + 4 * i]
            report["against"][d] = {"turns": t, "against_ms": [t[0], t[3]],
                                    "this_ms": [t[1], t[2]]}
        print(json.dumps(report))
    print(C._run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                  "--format=csv,noheader"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
