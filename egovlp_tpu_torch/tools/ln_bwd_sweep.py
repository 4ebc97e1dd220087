"""Device time of K3-bwd (the PyTorch port's LayerNorm backward,
``egovlp_tpu_torch/kernels/csrc/layer_norm_bwd.cu``) for variants of its
source, on one CUDA device.

    python3 -m egovlp_tpu_torch.tools.ln_bwd_sweep [VARIANT ...]   # from the repo root

A variant edits a copy of ``csrc`` before it is built:

* ``base``: the source as it is;
* ``stages=N``: ``kStages = N``, the rows of x and dy a warp stages in
  shared memory (N - 1 ahead of the row it computes);
* ``blocks=N``: ``kBwdBlocksPerSm = N``, the most blocks an SM takes;
* ``rows_only``: the kernel returns before its grid sync, so the time is
  the pass over the rows alone (dparams is not written: timing only);
* ``warps=N``: ``kWarps = N`` warps a block (``layer_norm.cuh``; the
  registers a thread then allowed are 65,536 / (32 N));
* ``no_loads``: x and dy are not copied in (the sweeps read whatever the
  ring holds): the compute and the dx stores alone (timing only);
* ``row_smem``: the second sweep reads the row from shared memory again and
  recomputes x_hat, instead of keeping x_hat and dy in registers;
* ``scale_l1``: with ``row_smem``, scale is loaded (from L1) in every sweep
  of every row instead of once into registers (take it with ``blocks=2``,
  as the registers then allow: the first design of this kernel).

Variants joined by ``+`` apply each edit in turn
(``row_smem+scale_l1+blocks=2``).

Beside the variants, one PyTorch elementwise kernel that moves the same
bytes, ``torch.add(x, dy, out=dx)`` on ``[rows + cls, D]`` (two inputs
read, one output written), is timed the same way: what the card's memory
gives such a stream.

Each variant's ``layer_norm_bwd.cu`` is built by its own nvcc into its own
library in a temporary directory (all at once), its K3 code in a
namespace of its own, and loaded with ctypes.  The variants then run in
turns (the order reversed every round, 3 rounds) in bf16 at the K3-bwd
shapes of ``chip_smoke.py``'s phase 3c: the CLS + patch pairs ``[25088 +
32, 1024]``, ``[25088 + 32, 768]``, ``[50176 + 16, 768]`` and the single
``[960, 768]`` and ``[32, 1024]``.  A time is the kernel's device time
(``torch.profiler``, mean of 20 launches, as ``chip_smoke.device_ms``),
median over the rounds.  Each variant's dx and [dscale; dbias] are first
held to the plain twin (relative L2; the timing-only variants are not
held).  Prints the card's name and power limit first.  Default variants:
``base row_smem row_smem+scale_l1+blocks=2 rows_only no_loads``.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import shutil
import statistics
import subprocess
import tempfile

SOURCE = "layer_norm_bwd.cu"
LINES = {"stages": "constexpr int kStages = 3;",
         "blocks": "constexpr int kBwdBlocksPerSm = 1;"}
SYNC = "cooperative_groups::this_grid().sync();"
SHAPES = ((25088, 32, 1024), (25088, 32, 768), (50176, 16, 768),
          (960, 0, 768), (32, 0, 1024))


UNPACK = ("        unpack(load16(sx + v * kN), xf);\n"
          "        unpack(load16(sdy + v * kN), g);\n")
XHAT = ("          const float xh = __fmul_rn(__fsub_rn(xf[i], m), rs);\n"
        "          const float gg = __fmul_rn(g[i], sc[j][i]);\n")
SCALE_REGS = ("  // the lane's slices of scale, held in registers for every row\n"
              "  float sc[kV][kN];\n#pragma unroll\n"
              "  for (int j = 0; j < kV; ++j) {\n"
              "    if (j * 32 + lane < slices) {\n"
              "      load_params(scale + (j * 32 + lane) * kN, sc[j]);\n"
              "    } else {\n#pragma unroll\n"
              "      for (int i = 0; i < kN; ++i) sc[j][i] = 0.f;\n    }\n  }\n")
WARPS = "constexpr int kWarps = 8;"


def edit_header(text: str, variant: str) -> str:
    """``text`` of ``layer_norm.cuh`` as ``variant`` has it."""
    for v in variant.split("+"):
        key, _, value = v.partition("=")
        if key == "warps":
            if WARPS not in text:
                raise SystemExit(f"layer_norm.cuh no longer holds {WARPS!r}")
            text = text.replace(WARPS, f"constexpr int kWarps = {int(value)};")
    return text


def edit(text: str, variant: str) -> str:
    """``text`` of ``layer_norm_bwd.cu`` as ``variant`` has it."""
    if "+" in variant:
        for v in variant.split("+"):
            text = edit(text, v)
        return text
    if variant.startswith("warps="):  # layer_norm.cuh's (edit_header)
        return text

    def swap(old, new):
        if old not in text:
            raise SystemExit(f"{SOURCE} no longer holds {old!r}")
        return text.replace(old, new)

    if variant == "base":
        return text
    if variant == "row_smem":
        text = swap("    // first sweep: the row's x_hat and dy, kept in registers for the\n"
                    "    // second, and the lane's sums of g and g * x_hat\n"
                    "    float xh[kV][kN], g[kV][kN];\n", "")
        text = swap("        float xf[kN];\n"
                    "        unpack(load16(sx + v * kN), xf);\n"
                    "        unpack(load16(sdy + v * kN), g[j]);\n",
                    "        float xf[kN], g[kN];\n" + UNPACK)
        text = swap("          xh[j][i] = __fmul_rn(__fsub_rn(xf[i], m), rs);\n"
                    "          const float gg = __fmul_rn(g[j][i], sc[j][i]);\n"
                    "          sg = __fadd_rn(sg, gg);\n"
                    "          sgx = __fadd_rn(sgx, __fmul_rn(gg, xh[j][i]));\n",
                    XHAT + "          sg = __fadd_rn(sg, gg);\n"
                    "          sgx = __fadd_rn(sgx, __fmul_rn(gg, xh));\n")
        return swap("        float out[kN];\n#pragma unroll\n"
                    "        for (int i = 0; i < kN; ++i) {\n"
                    "          const float gg = __fmul_rn(g[j][i], sc[j][i]);\n"
                    "          out[i] = __fmul_rn(rs, __fsub_rn(__fsub_rn(gg, m1), "
                    "__fmul_rn(xh[j][i], m2)));\n"
                    "          ds[j][i] = __fadd_rn(ds[j][i], __fmul_rn(g[j][i], xh[j][i]));\n"
                    "          db[j][i] = __fadd_rn(db[j][i], g[j][i]);\n",
                    "        float xf[kN], g[kN], out[kN];\n" + UNPACK
                    + "#pragma unroll\n        for (int i = 0; i < kN; ++i) {\n" + XHAT
                    + "          out[i] = __fmul_rn(rs, __fsub_rn(__fsub_rn(gg, m1), "
                    "__fmul_rn(xh, m2)));\n"
                    "          ds[j][i] = __fadd_rn(ds[j][i], __fmul_rn(g[i], xh));\n"
                    "          db[j][i] = __fadd_rn(db[j][i], g[i]);\n")
    if variant == "scale_l1":
        if "float xh[kV][kN], g[kV][kN];" in text:
            raise SystemExit("scale_l1 goes with row_smem (row_smem+scale_l1)")
        text = swap(SCALE_REGS, "")
        for decl in ("        float xf[kN], g[kN];\n",
                     "        float xf[kN], g[kN], out[kN];\n"):
            text = swap(decl + UNPACK, decl.replace("g[kN]", "g[kN], sc[kN]")
                        + UNPACK + "        load_params(scale + v * kN, sc);\n")
        return text.replace("sc[j][i]", "sc[i]")
    if variant == "no_loads":
        return swap("          cp_async16(smem_addr(sx + v * kN), xr + v * kN);\n"
                    "          cp_async16(smem_addr(sx + D + v * kN), dyr + v * kN);\n",
                    "")
    if variant == "rows_only":
        return swap(SYNC, "return;")
    key, _, value = variant.partition("=")
    if key not in LINES or not value.isdigit():
        raise SystemExit(f"unknown variant {variant!r}")
    old = LINES[key]
    return swap(old, old.rsplit("=", 1)[0] + f"= {int(value)};")


def build(tmp: pathlib.Path, variants):
    """Builds every variant at once; returns ``{variant: ctypes.CDLL}``."""
    from egovlp_tpu_torch.kernels import _build

    nvcc = _build.find_nvcc()
    procs = {}
    for i, v in enumerate(variants):
        csrc = tmp / f"csrc{i}"
        shutil.copytree(_build.CSRC, csrc)
        (csrc / SOURCE).write_text(edit((csrc / SOURCE).read_text(), v))
        header = csrc / "layer_norm.cuh"
        header.write_text(edit_header(header.read_text(), v))
        # each variant's K3 code in a namespace of its own: the libraries'
        # template instantiations would otherwise share their mangled names
        # in one process, and the cooperative launch of every library but
        # the first is refused (cudaError 720)
        for f in ("layer_norm.cuh", SOURCE):
            text = (csrc / f).read_text()
            (csrc / f).write_text(text.replace(
                "namespace k3 {", f"namespace k3v{i} {{").replace(
                "k3::", f"k3v{i}::"))
        lib = csrc / "libk3bwd.so"
        procs[v] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(csrc / SOURCE)], stderr=subprocess.PIPE, text=True))
    libs = {}
    for v, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {v}:\n{err}")
        handle = ctypes.CDLL(str(lib))
        for name in ("egovlp_layer_norm_bwd", "egovlp_layer_norm_bwd_grid",
                     "egovlp_layer_norm_bwd_attributes"):
            fn = getattr(handle, name)
            fn.argtypes, fn.restype = _build._SIGNATURES[name]
        libs[v] = handle
    return libs


def describe(lib, v: str, rows: int, D: int) -> str:
    """The variant's registers, spill bytes, shared memory at D 1024 and
    grid over ``rows`` rows of D (bf16)."""
    regs, local, smem, grid = (ctypes.c_int() for _ in range(4))
    rc = lib.egovlp_layer_norm_bwd_attributes(1, ctypes.byref(regs),
                                              ctypes.byref(local),
                                              ctypes.byref(smem))
    rc = rc or lib.egovlp_layer_norm_bwd_grid(rows, D, 1, 0,
                                              ctypes.byref(grid))
    return (f"{v}: {regs.value} registers, {local.value} spill bytes, "
            f"{smem.value} B shared at D 1024, grid {grid.value} at "
            f"[{rows}, {D}] (rc {rc})")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("variants", nargs="*",
                        default=["base", "row_smem",
                                 "row_smem+scale_l1+blocks=2", "rows_only",
                                 "no_loads"])
    args = parser.parse_args()

    import torch

    from chip_smoke import device_ms  # the repo root's, on sys.path under -m
    from egovlp_tpu_torch.kernels import fused_ln

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp), args.variants)
        cases = []
        for rows, cls, D in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(rows + D)
            shapes = [(rows, D)] + ([(cls, D)] if cls else [])
            xs = [(torch.randn(s, device="cuda", generator=g) * 2 + 0.5)
                  .bfloat16() for s in shapes]
            dys = [torch.randn(s, device="cuda", generator=g).bfloat16()
                   for s in shapes]
            scale = 1 + 0.3 * torch.randn(D, device="cuda", generator=g)
            stats = [fused_ln.layer_norm_fwd_plain(x, scale, scale, 1e-6)[1:]
                     for x in xs]
            want = [fused_ln.layer_norm_bwd_plain(x, scale, mu, rstd, dy)
                    for x, (mu, rstd), dy in zip(xs, stats, dys)]
            b = len(xs) - 1
            dxs = [torch.empty_like(x) for x in xs]
            part = torch.empty((8 * sms, 2 * D), device="cuda")
            dparams = torch.empty((2, D), device="cuda")
            ptrs = [t.data_ptr() for t in (
                xs[0], xs[b], dys[0], dys[b], scale, stats[0][0],
                stats[0][1], stats[b][0], stats[b][1], dxs[0], dxs[b], part,
                dparams)]
            stream = torch.cuda.current_stream().cuda_stream

            def launch(lib, ptrs=ptrs, rows=rows, cls=cls, D=D,
                       stream=stream):
                rc = lib.egovlp_layer_norm_bwd(*ptrs, rows, cls, D, 8 * sms,
                                               1, 0, stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            label = f"[{rows} + {cls}, {D}]" if cls else f"[{rows}, {D}]"
            for v, lib in list(libs.items()):
                try:
                    launch(lib)
                    torch.cuda.synchronize()
                except RuntimeError as e:  # a variant the card refuses
                    print(f"refused {describe(lib, v, rows + cls, D)}: {e}",
                          flush=True)
                    del libs[v]
                    continue

                def rel(got, w):
                    got, w = got.double(), w.double()
                    return ((got - w).norm() / w.norm()).item()

                err_dx = max(rel(dx, w[0]) for dx, w in zip(dxs, want))
                err_p = max(rel(dparams[i], sum(w[1 + i] for w in want))
                            for i in range(2))
                timing_only = "rows_only" in v or "no_loads" in v
                ok = timing_only or (err_dx <= 2e-3 and err_p <= 1e-5)
                print(f"check {v} {label}: dx rel {err_dx:.1e}, dparams rel "
                      f"{err_p:.1e} {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise SystemExit(f"{v} disagrees with the plain twin")
            cases.append((label, launch))
            a = torch.randn(rows + cls, D, device="cuda").bfloat16()
            b_, out = torch.randn_like(a), torch.empty_like(a)
            stream_ms = device_ms(lambda: torch.add(a, b_, out=out),
                                  library=True)
            print(f"time torch.add bf16 [{rows + cls}, {D}] (2 read, 1 "
                  f"written, K3-bwd's bytes): device {stream_ms * 1e3:.2f} us "
                  f"({3 * a.numel() * 2 / stream_ms / 1e6:.0f} GB/s) [{smi}]",
                  flush=True)
            del a, b_, out
        for v, lib in libs.items():
            print(describe(lib, v, 25088 + 32, 1024), flush=True)
        times = {(v, label): [] for v in libs for label, _ in cases}
        order = list(libs)
        for _ in range(3):
            for v in order:
                for label, launch in cases:
                    times[v, label].append(device_ms(
                        lambda lib=libs[v], launch=launch: launch(lib)))
            order.reverse()
    first = next(iter(libs))
    for label, _ in cases:
        base = statistics.median(times[first, label])
        for v in libs:
            t = statistics.median(times[v, label])
            print(f"time K3-bwd bf16 {label} {v}: device {t * 1e3:.2f} us "
                  f"({t / base:.3f}x {first}) [{smi}]", flush=True)


if __name__ == "__main__":
    main()
