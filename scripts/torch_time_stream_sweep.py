"""Device time of the streaming time-attention kernels (K2 and K5 of the
PyTorch port, forward and backward) for variants of the backward's run
length, on one CUDA device.

    python3 scripts/torch_time_stream_sweep.py [K2RUN:K5RUN ...] [--frames 4 16]

Each variant replaces the line that sets ``kRun`` in
``egovlp_tpu_torch/kernels/csrc/time_attention_stream.cuh`` (the warp
columns a warp of the backward walks in turn: K2 patch columns, K5 blocks
of 32 / P columns), builds the time kernels of a copy of ``csrc`` into
its own library in a temporary directory, and loads it with ctypes.  The
variants then run in turns (the order reversed every round, 6 rounds), at
the timed shapes of ``chip_smoke.py`` in bf16: K2 on ``[16, F, 196,
768]`` with 12 heads, K5 on the same tensors head-split, ``[192, F, 196,
64]``.  A time is one launch's share of 200 back-to-back launches between
two CUDA events (device time, no host gaps), median over the rounds.
The wrappers' CLS sums are not timed.  Prints the card's name and power
limit first.  Default variants: ``4:4 4:1 1:1``.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RUN_LINE = "constexpr int kRun = kSplit ? 1 : 4;"
SOURCES = ("time_attention_fwd.cu", "time_attention_bwd.cu",
           "time_attention_hs_fwd.cu", "time_attention_hs_bwd.cu")


def build_variant(tmp: pathlib.Path, k2_run: int, k5_run: int):
    """Compiles the time kernels with the given run lengths; returns the
    nvcc processes and the objects they write."""
    from egovlp_tpu_torch.kernels import _build

    csrc = tmp / f"csrc_{k2_run}_{k5_run}"
    shutil.copytree(_build.CSRC, csrc)
    header = csrc / "time_attention_stream.cuh"
    text = header.read_text()
    if RUN_LINE not in text:
        raise SystemExit(f"{header.name} no longer holds {RUN_LINE!r}")
    header.write_text(text.replace(
        RUN_LINE, f"constexpr int kRun = kSplit ? {k5_run} : {k2_run};"))
    nvcc = _build.find_nvcc()
    objs = [str(csrc / f"{s}.o") for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", o,
                               str(csrc / s)])
             for s, o in zip(SOURCES, objs)]
    return csrc, procs, objs


def link(csrc: pathlib.Path, objs) -> ctypes.CDLL:
    from egovlp_tpu_torch.kernels import _build

    out = str(csrc / "libvariant.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    out, *objs], check=True)
    lib = ctypes.CDLL(out)
    for name, (argtypes, restype) in _build._SIGNATURES.items():
        if name.startswith("egovlp_time_attention") or name.endswith(
                "error_string"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=["4:4", "4:1", "1:1"])
    ap.add_argument("--frames", type=int, nargs="+", default=[4, 16])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    runs = [tuple(int(x) for x in v.split(":")) for v in args.variants]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        started = [build_variant(pathlib.Path(tmp), *r) for r in runs]
        for _, procs, _ in started:
            if any(p.wait() != 0 for p in procs):
                raise SystemExit("nvcc failed")
        libs = {r: link(csrc, objs) for r, (csrc, _, objs) in zip(runs, started)}

        g = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        B, N, H, D = 16, 196, 12, 768
        hd = D // H

        def mk(*shape):
            return torch.randn(*shape, device="cuda", generator=g).to(
                torch.bfloat16)

        def ptrs(ts):
            return [t.data_ptr() for t in ts]

        for F in args.frames:
            k2 = [mk(B, F, N, D) for _ in range(3)] + [mk(B, 1, D),
                                                       mk(B, 1, D),
                                                       mk(B, F, N, D)]
            k5 = [t.reshape(B, F, N, H, hd).permute(0, 3, 1, 2, 4)
                  .reshape(B * H, F, N, hd).contiguous() for t in k2[:3]]
            k5[0] = k5[0] * hd ** -0.5
            k5 += [t.reshape(B * H, 1, hd).contiguous() for t in k2[3:5]]
            k5.append(k2[5].reshape(B, F, N, H, hd).permute(0, 3, 1, 2, 4)
                      .reshape(B * H, F, N, hd).contiguous())
            # outputs, and CLS scratch of a row a patch column: ample for
            # any run length
            o2 = [torch.empty_like(k2[0]) for _ in range(4)] + [
                torch.empty(B, N, D, device="cuda") for _ in range(2)]
            o5 = [torch.empty_like(k5[0]) for _ in range(4)] + [
                torch.empty(B * H, N, hd, device="cuda") for _ in range(2)]

            def calls(lib):
                return {
                    "K2-fwd": lambda: lib.egovlp_time_attention_fwd(
                        *ptrs(k2[:5]), o2[0].data_ptr(), B, F, N, D, H,
                        hd ** -0.5, 1, 0, stream),
                    "K2-bwd": lambda: lib.egovlp_time_attention_bwd(
                        *ptrs(k2), *ptrs(o2[1:]), B, F, N, D, H, hd ** -0.5,
                        1, 0, stream),
                    "K5-fwd": lambda: lib.egovlp_time_attention_hs_fwd(
                        *ptrs(k5[:5]), o5[0].data_ptr(), B * H, F, N, hd, 0,
                        1, 0, stream),
                    "K5-bwd": lambda: lib.egovlp_time_attention_hs_bwd(
                        *ptrs(k5), *ptrs(o5[1:]), B * H, F, N, hd, 0, 1, 0,
                        stream),
                }

            def per_launch(fn, n=200):
                for _ in range(10):
                    if fn() != 0:
                        raise SystemExit("launch failed")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    fn()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / n

            times = {}
            for rnd in range(6):
                for r in (runs if rnd % 2 == 0 else runs[::-1]):
                    for name, fn in calls(libs[r]).items():
                        times.setdefault((name, r), []).append(per_launch(fn))
            for (name, r), ts in sorted(times.items()):
                print(f"f{F} {name} kRun K2 {r[0]} K5 {r[1]}: median "
                      f"{statistics.median(ts) * 1e3:.2f} us (min "
                      f"{min(ts) * 1e3:.2f}, max {max(ts) * 1e3:.2f}) "
                      f"[{smi}]", flush=True)
            del k2, k5, o2, o5


if __name__ == "__main__":
    main()
