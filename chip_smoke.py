#!/usr/bin/env python3
"""GPU check of the PyTorch/CUDA port: builds the CUDA kernels, holds each
against its plain PyTorch version at every SpectralBlock shape of the
256x256 forward, then serves a batch through the full-width
SpectralTransformer and checks where the time and the launches went.

    python3 chip_smoke.py            # needs one CUDA GPU; no arguments

Phases (any failure exits non-zero; nothing is caught and continued):
1. setup: card name and power limit, kernel build time, TF32 off;
2. kernels: ln_gdfn and ln_mdta vs their plain versions at the five block
   shapes and the serving batch (and at two shapes with ragged edge tiles),
   in f32 and in bf16, each against the plain version on the same input, so
   both round at the same points; the error is scaled by the branch
   max|ref - x|, with weights that make the branch O(1); then median times
   of kernel and plain version on the same inputs;
3. model: ``batched_apply`` on a uint8 batch of 8 at 256x256 in bf16 through
   the kernels, launch counts read from a run that starts at zero, output
   checked against the plain-version model in f32 and in bf16, with limits
   shown to lie below what a model without its MDTA or GDFN branches
   produces; images/s.
The last line is the JSON device record; the line before it the kernels'.
"""
import copy
import json
import os
import subprocess
import sys
import time

SHAPES = ((16, 256, 256, 1), (32, 128, 128, 2), (64, 64, 64, 4),
          (128, 32, 32, 8), (32, 256, 256, 1))   # (C, H, W, heads)
# ragged tiles at the bottom and right edges; checked, not timed
EDGE_SHAPES = ((32, 20, 36, 2), (128, 12, 20, 8))
EXPANSION = 2.66
# f32: the kernel and the plain version sum the same products in another
# order (9C-deep contractions, gram sums over up to 65536 pixels); bf16: both
# round to bf16 at the same points, and a sum that lands on the other side of
# a rounding boundary moves y by one bf16 ulp of |y| (1/32 at |y| in [4, 8)).
# Scaled by max|ref - x|, the branch: a kernel that skipped the branch would
# score 1, one that scaled it by 0.95 about 5e-2.  Readings on an H100 at
# these shapes: f32 at most 8.1e-6, bf16 at most 1.16e-2.
KERNEL_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
# model, absolute on the [-1, 1] output: kernels vs the plain model in the
# same dtype through 24 blocks, cuFFT and cuDNN (TF32 off).  Each must be at
# most a quarter of how far the output moves without the MDTA branches, or
# without the GDFN ones (3.4e-2 and 7.8e-2 on an H100).  Readings there:
# f32 5.6e-6, bf16 2.4e-3.
MODEL_TOL = {"float32": 5e-5, "bfloat16": 5e-3}
# attention temperature of every block in the model phase: torch's default
# (1) leaves the softmax near uniform, where dropping every MDTA branch moves
# the output by about as much as bf16 rounding does
MODEL_TEMPERATURE = 16.0
HBM_BYTES_PER_S = 3.35e12
BF16_PEAK_FLOPS = 989e12  # dense tensor-core peak
REPLACES = {
    "ln_gdfn": "underwater_image_restoration_tpu/ops/fused_gdfn_banded.py:479",
    "ln_mdta": ("underwater_image_restoration_tpu/ops/fused_attn_composed.py:"
                "523; underwater_image_restoration_tpu/ops/"
                "fused_attn_banded.py:648"),
}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def median_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def block_inputs(c, h, w, nh, batch, seed):
    """Seeded input and block weights, drawn on the host and moved to the
    card.  x ~ N(0, 1); every 1x1 is N(0, 1/fan_in) and every 3x3 tap
    N(0, 1/9), so each keeps unit variance; LN affine perturbed, temperatures
    about 16 (a peaked softmax) and project_outf times 4: both branches
    y - x are O(1) beside x."""
    import torch

    g = torch.Generator().manual_seed(seed)
    hid = int(c * EXPANSION)

    def n(*shape, fan_in=1):
        return torch.randn(shape, generator=g) / fan_in ** 0.5

    x = n(batch, c, h, w)
    ln = (1 + 0.1 * n(c), 0.1 * n(c))
    mdta = (n(c, 3 * c, fan_in=c), n(3, 3, 3 * c, fan_in=9),
            16 * (1 + 0.2 * n(1, nh, 1, 1)), n(c, c, fan_in=c),
            n(c, 2 * c, fan_in=c), n(3, 3, 2 * c, fan_in=9),
            4 * n(c, c, fan_in=c))
    gdfn = (n(c, 2 * hid, fan_in=c), n(3, 3, 2 * hid, fan_in=9),
            n(hid, c, fan_in=hid))
    return tuple(t.cuda() if torch.is_tensor(t) else tuple(a.cuda() for a in t)
                 for t in (x, ln, mdta, gdfn))


def work(name, c, h, w, nh, batch, itemsize):
    """(bytes, flops) the function needs at least: x read once, y written
    once, weights read once; the multiply-adds of the unfolded chains
    (1x1 then depthwise 3x3, the cheaper order)."""
    px = batch * h * w
    hid = int(c * EXPANSION)
    act = 2 * batch * c * h * w * itemsize
    if name == "ln_gdfn":
        wbytes = 4 * (2 * c + 2 * hid * c + 9 * 2 * hid + hid * c)
        flops = px * (2 * c * 2 * hid + 2 * 9 * 2 * hid + 2 * hid * c)
    else:
        cph = c // nh
        wbytes = 4 * (2 * c + 3 * c * c + 27 * c + nh + c * c + c * c
                      + 9 * c + c * c)
        flops = px * (2 * c * 3 * c + 2 * 9 * 3 * c      # q, k, v
                      + 2 * c * cph + 4 * c              # gram, Sq, Sk
                      + 2 * 2 * c * cph                  # A v, A vf
                      + 2 * c * c + 2 * c * c + 2 * 9 * c  # out, vf
                      + 2 * c * c)                       # project_outf
    return act + wbytes, flops


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this check needs "
              "an NVIDIA GPU", flush=True)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.eval import (
        batched_apply,
        psnr_float_pm1,
    )
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.models.spectral_transformer import (
        MDTA,
        SpectralBlock,
    )
    from underwater_image_restoration_torch.ops import (
        _kernels,
        ln_gdfn,
        ln_gdfn_plain,
        ln_mdta,
        ln_mdta_plain,
    )
    from underwater_image_restoration_torch.tools import profile_serving

    # the serving cell's shape, as the profiler traces it
    SERVE_BATCH, SIZE = profile_serving.BATCH, profile_serving.SIZE

    # ---- 1. setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"{smi} ({torch.cuda.get_device_name(0)})"
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = _kernels.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}: {info['path']}", flush=True)
        for ln in regs:
            print(f"    ptxas {ln}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. kernels vs plain versions
    fns = {"ln_gdfn": (ln_gdfn, ln_gdfn_plain),
           "ln_mdta": (ln_mdta, ln_mdta_plain)}

    def call(name, fn, x, ln, mdta, gdfn, nh):
        if name == "ln_gdfn":
            return fn(x, *ln, *gdfn)
        return fn(x, *ln, *mdta, nh)

    def check(name, c, h, w, nh, batch, seed):
        """Kernel vs plain version on the same input, in f32 and in bf16;
        returns the bf16 inputs and the larger max abs error."""
        x, ln, mdta, gdfn = block_inputs(c, h, w, nh, batch, seed)
        kern, plain = fns[name]
        worst = 0.0
        for dt in (torch.float32, torch.bfloat16):
            xin = x.to(dt)
            got = call(name, kern, xin, ln, mdta, gdfn, nh).float()
            ref = call(name, plain, xin, ln, mdta, gdfn, nh).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            branch = (ref - xin.float()).abs().max().item()
            rel = err / branch
            tol = KERNEL_TOL[str(dt).split(".")[1]]
            ok = bool(torch.isfinite(got).all()) and rel <= tol
            print(f"{name} C={c} {h}x{w} heads={nh} batch {batch} {dt}: "
                  f"max_abs {err:.3e} max|branch| {branch:.3f} max_abs/"
                  f"max|branch| {rel:.3e} tol {tol:.0e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{name} disagrees with its plain version at C={c} "
                     f"{h}x{w} {dt}")
            worst = max(worst, err)
        return (x.to(torch.bfloat16), ln, mdta, gdfn), worst

    for c, h, w, nh in EDGE_SHAPES:
        for name in fns:
            check(name, c, h, w, nh, 2, seed=c + h)
    rows = {}
    for c, h, w, nh in SHAPES:
        for name, (kern, plain) in fns.items():
            (xb, ln, mdta, gdfn), err = check(name, c, h, w, nh, SERVE_BATCH,
                                              seed=c + h)
            # times on the same inputs, in the serving dtype (bf16)
            ms = median_ms(lambda: call(name, kern, xb, ln, mdta, gdfn, nh))
            pms = median_ms(lambda: call(name, plain, xb, ln, mdta, gdfn, nh),
                            reps=5, warmup=1)
            nbytes, flops = work(name, c, h, w, nh, SERVE_BATCH, 2)
            tb = nbytes / HBM_BYTES_PER_S * 1e3
            tf = flops / BF16_PEAK_FLOPS * 1e3
            rows[(name, c, h, w)] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")
            print(f"{name} C={c} {h}x{w} bf16 batch {SERVE_BATCH}: kernel "
                  f"{ms:.4f} ms, plain {pms:.4f} ms, bound {max(tb, tf):.4f}"
                  f" ms ({'bytes' if tb >= tf else 'operations'}) on {card}",
                  flush=True)
            del xb
    torch.cuda.empty_cache()

    # ---- 3. model: the serving path at full width
    model = init_model("SpectralTransformer", seed=0,
                       compute_dtype=torch.bfloat16)
    with torch.no_grad():
        for blk in model.modules():
            if isinstance(blk, MDTA):
                blk.temperature.fill_(MODEL_TEMPERATURE)
    raw, _ = synthetic_pair_batch(SERVE_BATCH, SIZE, seed=0)
    apply_b, _ = batched_apply(model, SERVE_BATCH)
    apply_b(raw)  # warm-up: cuFFT plans, cuDNN algorithms
    torch.cuda.synchronize()
    ln_gdfn.launches.clear()
    ln_mdta.launches.clear()
    y = apply_b(raw)
    torch.cuda.synchronize()
    n_gdfn = sum(ln_gdfn.launches.values())
    n_mdta = sum(ln_mdta.launches.values())
    launches = {"ln_gdfn": dict(ln_gdfn.launches),
                "ln_mdta": dict(ln_mdta.launches)}
    print(f"launches in one forward: ln_gdfn {n_gdfn}, ln_mdta {n_mdta} "
          f"(2 a block: stats + apply)", flush=True)
    for name in launches:
        for (c, h, w), n in sorted(launches[name].items()):
            print(f"  {name} C={c} {h}x{w}: {n}", flush=True)
    if n_gdfn != 24 or n_mdta != 48:
        fail(f"expected 24 ln_gdfn and 48 ln_mdta launches, got {n_gdfn} "
             f"and {n_mdta}")
    if tuple(y.shape) != (SERVE_BATCH, SIZE, SIZE, 3):
        fail(f"output shape {tuple(y.shape)}")
    if not bool(torch.isfinite(y).all()):
        fail("non-finite output")

    def outputs(m, dt, use_kernels):
        m.compute_dtype = dt
        out = batched_apply(m, SERVE_BATCH, use_kernels)[0](raw)
        torch.cuda.synchronize()
        return out

    def without(branch):
        """The model with every block's MDTA or GDFN output projection
        zeroed: what kernels that returned x unchanged would give."""
        m = copy.deepcopy(model)
        for blk in m.modules():
            if isinstance(blk, SpectralBlock):
                proj = (blk.attn.project_outf if branch == "MDTA"
                        else blk.ffn.project_out)
                proj.weight.data.zero_()
        return m

    refs = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[1]
        refs[tag] = ref = outputs(model, dt, False)
        out = y if dt == torch.bfloat16 else outputs(model, dt, True)
        err = (out - ref).abs().max().item()
        gone = {b: (outputs(without(b), dt, False) - ref).abs().max().item()
                for b in ("MDTA", "GDFN")}
        tol = MODEL_TOL[tag]
        print(f"model {tag} kernels vs {tag} plain model: max_abs {err:.3e} "
              f"tol {tol:.0e}; without the MDTA branches the plain model "
              f"moves {gone['MDTA']:.3e}, without GDFN {gone['GDFN']:.3e}",
              flush=True)
        if not tol <= min(gone.values()) / 4:
            fail(f"the {tag} model limit would not see a missing branch")
        if not err <= tol:
            fail(f"model output ({tag}) disagrees with the plain model")
    err = (y - refs["float32"]).abs().max().item()
    psnr = psnr_float_pm1(refs["float32"].cpu().numpy(), y.cpu().numpy())
    print(f"model bf16 kernels vs f32 plain model: max_abs {err:.3e}, PSNR "
          f"{psnr:.2f} dB", flush=True)
    model.compute_dtype = torch.bfloat16

    def serve_rate(fn, iters):
        fn(raw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn(raw)
        torch.cuda.synchronize()
        return iters * SERVE_BATCH / (time.perf_counter() - t)

    apply_plain_bf16, _ = batched_apply(model, SERVE_BATCH, use_kernels=False)
    ips = serve_rate(apply_b, 10)
    ips_plain = serve_rate(apply_plain_bf16, 3)
    print(f"serving SpectralTransformer {SIZE}x{SIZE} bf16 batch "
          f"{SERVE_BATCH}: {ips:.2f} images/s with the kernels, "
          f"{ips_plain:.2f} images/s with the plain versions, on {card}",
          flush=True)

    # ---- the record
    kernels = []
    for (name, c, h, w), row in rows.items():
        kernels.append({
            "name": f"{name}[C={c},{h}x{w}]",
            "route": "cuda",
            "source": f"underwater_image_restoration_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name].get((c, h, w), 0),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
