"""Where the serving path's time goes on the GPU.

Traces ITERS ``batched_apply`` calls of a full-width model (the serving
cell: SIZE x SIZE, batch BATCH, bf16, seeded weights; SpectralTransformer,
AST with ``--arch AST`` or NewModel with ``--arch NewModel``, ``--use-dwt``
Wavelet, the default, or Fourier) with ``torch.profiler`` and prints device
time by kernel, grouped into the port's own kernels, cuDNN/cuBLAS
convolutions and matrix products, FFTs and the rest, beside the wall time
of the same calls, so the device's idle share shows.  Needs a CUDA GPU:

    python -m underwater_image_restoration_torch.tools.profile_serving \
        [--arch AST|NewModel [--use-dwt Wavelet|Fourier]]
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ..data import synthetic_pair_batch
from ..eval import batched_apply
from ..models import init_model

# the serving cell's shape (``chip_smoke.py`` serves the same) and the
# number of traced batches
BATCH = 8
SIZE = 256
ITERS = 5

GROUPS = (
    ("ln_gdfn kernel", ("ln_gdfn_fwd_kernel", "ln_gdfn_fwd_sum_kernel")),
    # the staged kernels' products run in csrc/gemm.cuh's gemm_kernel, told
    # apart by their epilogues; the first group a name matches takes it
    ("ln_mdta products", ("MdtaFwd",)),
    ("ln_mdta taps passes", ("ln_mdta_fwd_taps",)),
    ("ln_mdta prep, weights, stats and A", (
        "ln_mdta_fwd_prep_kernel", "ln_mdta_fwd_weights_kernel",
        "ln_mdta_fwd_attn_kernel")),
    ("ln_leff products (fc1, fc2)", ("LeffFwdFc1Epi", "LeffFwdFc2Epi")),
    ("ln_leff prep and g2 window", ("ln_leff_fwd_prep_kernel",
                                    "ln_leff_fwd_dw_kernel")),
    ("ln_leff_bwd products", ("Fc1Epi", "Dg2Epi", "WgradEpi", "::DlnEpi")),
    ("ln_leff_bwd depthwise pass", ("ln_leff_bwd_dw_kernel",)),
    ("ln_leff_bwd prep and row sums", ("ln_leff_bwd_prep_kernel",
                                       "reduce_rows_kernel<5>")),
    ("window_attn kernel", ("window_attn_fwd_kernel",)),
    ("window_attn_bwd kernel and dw step", ("window_attn_bwd_kernel",
                                            "window_attn_dw_kernel")),
    ("ln_gdfn_bwd kernel", ("ln_gdfn_bwd_kernel",)),
    ("ln_mdta_bwd products", ("MdtaBwd",)),
    ("ln_mdta_bwd taps passes", ("ln_mdta_bwd_taps",)),
    ("ln_mdta_bwd prep, A, softmax and row sums", (
        "ln_mdta_bwd_prep_kernel", "ln_mdta_bwd_attn_kernel",
        "ln_mdta_bwd_softmax_kernel", "reduce_rows_kernel<7>")),
    ("backward row sums", ("reduce_rows_kernel",)),
    ("fft", ("fft", "FFT", "regular_fft", "vector_fft")),
    ("conv and matmul (cuDNN/cuBLAS)", ("conv", "Conv", "cudnn",
                                        "implicit", "xmma", "cutlass",
                                        "gemm", "nchw", "Nhwc")),
    ("optimizer (multi-tensor)", ("multi_tensor", "foreach")),
)


def group_of(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other (elementwise, copies, weight prep)"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def profile(fn, iters: int, what: str, ranges=None, steps: int = 1) -> int:
    """Trace ``iters`` calls of ``fn`` (warmed up by the caller) and print
    wall time a call, the host's time a call to issue them (before the
    closing synchronise), device busy and idle shares, device time by group
    and the top kernels; with ``steps`` (the train steps one call runs) the
    times are a step's.  ``ranges`` maps the name of a
    ``torch.profiler.record_function`` range to the groups whose kernels
    run only inside it: the range's device time is the kernels the profiler
    ties to it (those of torch operators) plus those groups (the port's
    kernels, launched through ctypes, which it does not tie to a range).
    Returns 1 if the profiler saw no device time."""
    ranges = ranges or {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    per = iters * steps  # the times are over the calls' steps
    unit = "a step" if steps > 1 else "a call"
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / per
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / per
    by_group: dict[str, float] = {}
    in_range = dict.fromkeys(ranges, 0.0)
    kernels = []
    for ev in prof.key_averages():
        if ev.key in in_range:
            # the range's host event sums its kernels; its device-side
            # annotation would count them twice
            if ev.device_type == torch.autograd.DeviceType.CPU:
                in_range[ev.key] += ev.device_time_total
            continue
        # device-side events only: an aten op's row repeats its kernels'
        # time, and a range's device-side annotation (Optimizer.step's)
        # spans them
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0:
            continue
        kernels.append((dev_us, ev.key, ev.count))
        g = group_of(ev.key)
        by_group[g] = by_group.get(g, 0.0) + dev_us
    for name, groups in ranges.items():
        in_range[name] += sum(by_group.get(g, 0.0) for g in groups)
    total_ms = sum(by_group.values()) / 1e3 / per
    print(f"{what}: wall {wall_ms:.3f} ms {unit} under the profiler (the "
          f"host's issue {host_ms:.3f} ms), device busy {total_ms:.3f} ms "
          f"({100 * total_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - total_ms / wall_ms):.1f}%")
    if not kernels:
        print("the profiler saw no device time")
        return 1
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / per
        print(f"  {g}: {ms:.3f} ms {unit} ({100 * ms / total_ms:.1f}% of "
              "device time)")
    for name, us in in_range.items():
        ms = us / 1e3 / per
        print(f"  of which inside '{name}': {ms:.3f} ms {unit} "
              f"({100 * ms / total_ms:.1f}% of device time)")
    print(f"top kernels (device ms {unit}, launches {unit}):")
    for us, name, count in sorted(kernels, reverse=True)[:15]:
        print(f"  {us / 1e3 / per:8.3f}  {count // per:4d}  "
              f"{name[:100]}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="SpectralTransformer",
                   choices=("SpectralTransformer", "AST", "NewModel"))
    p.add_argument("--use-dwt", default="Wavelet",
                   choices=("Wavelet", "Fourier"),
                   help="NewModel's frequency branch")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    print(card())
    model = init_model(args.arch, seed=0, compute_dtype=torch.bfloat16,
                       img_size=SIZE, use_dwt=args.use_dwt)
    raw, _ = synthetic_pair_batch(BATCH, SIZE, seed=0)
    apply_b, _ = batched_apply(model, BATCH)
    for _ in range(2):
        apply_b(raw)
    torch.cuda.synchronize()
    arch = args.arch + ("-" + args.use_dwt if args.arch == "NewModel"
                        else "")
    return profile(lambda: apply_b(raw), ITERS,
                   f"{arch} batch {BATCH} at {SIZE}x{SIZE} bf16")


if __name__ == "__main__":
    raise SystemExit(main())
