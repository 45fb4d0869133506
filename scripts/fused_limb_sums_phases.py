"""Where the time of the fused_limb_sums kernel goes, on one CUDA card.

    python3 scripts/fused_limb_sums_phases.py [--sf 1.0] [--repeats 5]

Builds presto_tpu_torch/ops/csrc/fused_limb_sums.cu a second time with
-DFUSED_LIMB_SUMS_PHASES (phase clocks in the chunk loop of block 0),
runs TPC-H q1 once through run_query to take the lanes it hands the
kernel, then calls the clocked kernel on them and prints one JSON
object: the kernel's device time (torch.profiler), block 0's chunks and
its clock cycles per chunk in each phase (issuing the next chunk's
copies, waiting for this chunk's copies, the limb split, the sums), the
SM clock and the card's name and power limit. Needs a CUDA device.
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

PHASES = ("issue copies", "wait copies", "split", "sums")


def build_clocked():
    """The kernel with its phase clocks, built beside the plain one."""
    from presto_tpu_torch.ops import kernels as K
    src = os.path.join(K._CSRC, "fused_limb_sums.cu")
    os.makedirs(K._BUILD, exist_ok=True)
    so = os.path.join(K._BUILD, "fused_limb_sums-phases.so")
    proc = subprocess.run([K._nvcc(), *K._NVCC_FLAGS,
                           "-DFUSED_LIMB_SUMS_PHASES", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    for fn, argtypes in K._SIGNATURES["fused_limb_sums"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.fused_limb_sums_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fused_limb_sums_phases.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fused_limb_sums_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.ops import kernels as K
    chip_smoke.install_host_cache()
    lib = build_clocked()

    calls = []
    fused = K.fused_limb_sums

    def recording(ids, sources, requests, groups, **kw):
        if not calls:
            calls.append((ids, sources, requests, groups))
        return fused(ids, sources, requests, groups, **kw)

    K.fused_limb_sums = recording
    try:
        run_query(chip_smoke.as_built(chip_smoke.q1_plan(), args.sf),
                  sf=args.sf, prepared=True)
    finally:
        K.fused_limb_sums = fused
    ids, sources, requests, groups = calls[0]
    want = K.fused_limb_sums_reference(ids, sources, requests, groups)

    K._libs["fused_limb_sums"] = lib  # the clocked build from here on
    if not torch.equal(K.fused_limb_sums(ids, sources, requests, groups),
                       want):
        raise AssertionError("the clocked kernel disagrees with the plain "
                             "version")
    device_ms = chip_smoke.device_ms(
        lambda: K.fused_limb_sums(ids, sources, requests, groups),
        "fused_limb_sums_kernel", args.repeats)
    lib.fused_limb_sums_phases(None, 1)
    for _ in range(args.repeats):
        K.fused_limb_sums(ids, sources, requests, groups)
    torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * 4)()
    if lib.fused_limb_sums_phases(cycles, 0) != 0:
        raise RuntimeError("reading the phase clocks failed")
    chunks = -(-ids.shape[0] // 1024)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_block = -(-chunks // min(sms, chunks))  # one block per SM at q1
    gpu = chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"])
    clock = chip_smoke._run(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader"])
    report = {
        "gpu": gpu, "sm_clock": clock, "device_ms": device_ms,
        "rows": ids.shape[0], "groups": groups, "requests": len(requests),
        "sources": len(sources), "block0_chunks": per_block,
        "cycles_per_chunk": {
            name: cycles[i] / (per_block * args.repeats)
            for i, name in enumerate(PHASES)}}
    print(json.dumps(report))
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
