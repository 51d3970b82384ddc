"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, cached under ``build/kernels/`` by a hash
of the sources (``.cu`` and shared ``.cuh``) and the flags, and loaded with
``ctypes``.  Nothing here runs at import time: the first ``library(name)``
call builds what is missing, so the CPU tests can import every module of
the port.

The C functions take raw device pointers and the CUDA stream as integers and
return the ``cudaError_t`` of the launch; ``check`` raises on a non-zero one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)
# C signature of every exported function: (library, symbol) -> argtypes
SIGNATURES = {
    ("ln_gdfn", "uir_ln_gdfn_fwd"):
        # x, y, part, scale, bias, w_in hi, w_in lo, taps, w_out hi, w_out
        # lo, B, C, H, W, hid_pad, gate_chunk, bf16, TH, TW, splits, eps,
        # stream
        [_P] * 10 + [_I] * 10 + [_F, _P],
    ("ln_gdfn", "uir_ln_gdfn_weights"):
        # w_in, w_dw, w_out, w_in hi, w_in lo, taps, w_out hi, w_out lo, C,
        # hid, hid_pad, stream
        [_P] * 8 + [_I] * 3 + [_P],
    ("ln_mdta", "uir_ln_mdta_fwd"):
        # x, y, scale, bias, w_qkv, t_qkv, w_po, w_kv, t_kv, w_pof, temp,
        # stats, workspace, B, C, H, W, cph, bf16, images a slice, pixels a
        # range of an image's gram, eps, stream
        [_P] * 13 + [_I] * 8 + [_F, _P],
    ("ln_mdta", "uir_ln_mdta_fwd_stats"):
        # x, scale, bias, w_qkv, t_qkv, w_po, w_kv, t_kv, w_pof, temp,
        # stats, workspace, B, C, H, W, cph, bf16, images a slice, pixels a
        # range of an image's gram, first and end row of the stats, eps,
        # stream
        [_P] * 12 + [_I] * 10 + [_F, _P],
    ("ln_mdta", "uir_ln_mdta_fwd_apply"):
        # x, y, scale, bias, w_qkv, t_qkv, w_po, w_kv, t_kv, w_pof, temp,
        # stats, workspace, B, C, H, W, cph, bf16, images a slice, pixels a
        # range of an image's gram, eps, stream
        [_P] * 13 + [_I] * 8 + [_F, _P],
    ("ln_gdfn_bwd", "uir_ln_gdfn_bwd"):
        # x, dy, dx, scale, bias, w_in hi, w_in lo, taps, w_out hi, w_out
        # lo, part, grads, B, C, H, W, hid_pad, gate_chunk, bf16, TH, TW,
        # groups, eps, stream
        [_P] * 12 + [_I] * 10 + [_F, _P],
    ("ln_mdta_bwd", "uir_ln_mdta_bwd"):
        # x, dy, dx, scale, bias, w_qkv, t_qkv, w_po, w_kv, t_kv, w_pof,
        # temp, stats, workspace, grads, dtemp, B, C, H, W, cph, bf16,
        # images a slice, pixels a split, pixels a split of an image's dA,
        # eps, stream
        [_P] * 16 + [_I] * 9 + [_F, _P],
    ("ln_mdta_bwd", "uir_ln_mdta_bwd_stage1"):
        # x, dy, scale, bias, w_qkv, t_qkv, w_po, w_kv, t_kv, w_pof, temp,
        # stats, workspace, dA, B, C, H, W, cph, bf16, images a slice,
        # pixels a split, pixels a split of an image's dA, eps, stream
        [_P] * 14 + [_I] * 9 + [_F, _P],
    ("ln_mdta_bwd", "uir_ln_mdta_bwd_stage2"):
        # x, dy, dx, scale, bias, w_qkv, t_qkv, w_po, w_kv, t_kv, w_pof,
        # temp, stats, workspace, grads, dtemp, dA, dA of the rank, B, C, H,
        # W, cph, bf16, images a slice, pixels a split, pixels a split of an
        # image's dA, first and end row of the stats, accumulate, eps,
        # stream
        [_P] * 18 + [_I] * 12 + [_F, _P],
    ("ln_leff", "uir_ln_leff_fwd"):
        # x, y, scale, bias, w1 hi, w1 mid, b1, taps, bdw, w2 hi, w2 mid,
        # b2, w1 lo, w2 lo, s, workspace, B, H, W, C, hid_pad, residual,
        # bf16, images a slice, eps, stream
        [_P] * 16 + [_I] * 8 + [_F, _P],
    ("ln_leff_bwd", "uir_ln_leff_bwd"):
        # x, dy, dx, scale, bias, w1 hi, w1 lo, b1, taps, bdw, w2 hi, w2 lo,
        # s, workspace, grads, B, H, W, C, hid_pad, residual, bf16, images a
        # slice, pixels a split, eps, stream
        [_P] * 15 + [_I] * 9 + [_F, _P],
    ("window_attn", "uir_window_attn_fwd"):
        # q, k, v, out, strides (12 int64, host), bias, mask, w, BQ, H, N,
        # D, nW, windows a block, scale, bf16, aligned-row bits, stream
        [_P] * 4 + [_LL] + [_P] * 3 + [_I] * 6 + [_F, _I, _I, _P],
    ("window_attn_bwd", "uir_window_attn_bwd"):
        # q, k, v, dO, dq, dk, dv, strides (21 int64, host), bias, mask, w,
        # part, sums, dbias, dw, BQ, H, N, D, nW, windows a block, scale,
        # bf16, aligned-row bits, stream
        [_P] * 7 + [_LL] + [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            "kernels are built on the machine with the GPU")
    return found


def _target(name: str) -> Path:
    """Cache path of library ``name``: keyed by the flags and every source in
    ``csrc/`` (the kernels share headers), so any edit there rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def kernel_names() -> list[str]:
    return sorted({lib for lib, _ in SIGNATURES})


def build_all(names=None) -> dict[str, dict]:
    """Compile every missing library, one ``nvcc`` process per source, all
    started together.  Returns {name: {"path", "seconds", "log"}}; raises
    with the compiler's output if any build fails."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = {"path": str(target), "seconds": 0.0,
                         "log": "cached"}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = {"path": str(target),
                     "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        info = build_all([name])[name]
        lib = ctypes.CDLL(info["path"])
        for (lname, sym), argtypes in SIGNATURES.items():
            if lname == name:
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.uir_error_string.argtypes = [ctypes.c_int]
        lib.uir_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check_plain(what: str, *tensors) -> None:
    """Refuse a DTensor (a sharded parameter or its gradient): a kernel
    reads whole tensors through their raw pointers.  FSDP2 hands the blocks
    plain unsharded tensors in forward and backward, so none reaches here
    from the model."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:  # not imported: no DTensor exists
        return
    for t in tensors:
        if isinstance(t, mod.DTensor):
            raise TypeError(f"{what}: a DTensor reached the kernel (shape "
                            f"{tuple(t.shape)}); pass plain tensors")


def check_input(what: str, x, *weights) -> None:
    """Validate what a kernel takes: a contiguous float32/bfloat16
    (B, C, H, W) CUDA tensor with C a multiple of 4, and weights on its
    device, none of them a DTensor."""
    import torch

    check_plain(what, x, *weights)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes a CUDA tensor, x is "
                         f"on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: x must be float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (B, C, H, W) "
                         f"tensor, got shape {tuple(x.shape)}")
    if x.shape[1] % 4:
        raise ValueError(f"{what}: C={x.shape[1]} must be a multiple of 4")
    for t in weights:
        if t.device != x.device:
            raise ValueError(f"{what}: weights on {t.device}, x on "
                             f"{x.device}")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.uir_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count(device.index or 0)


def block_rows(tiles: int, device) -> int:
    """Blocks of a backward tile kernel, each owning one row of weight-
    gradient partials: two a streaming multiprocessor (each block walks over
    tiles blockIdx.x, blockIdx.x + grid, ...), no more than there are
    tiles."""
    return max(1, min(tiles, 2 * sm_count(device)))


def split_bf16(t, planes: int = 2):
    """The bf16 planes of a tensor-core operand (csrc/mma.cuh): hi =
    bf16(t), lo = bf16(t - hi), which carry an f32 t to about 2^-17 of |t|;
    with three planes, hi, mid = bf16(t - hi) and lo = bf16(t - hi - mid),
    about 2^-24.  A bf16 t is its own hi plane, and the others (never read)
    are t again."""
    import torch

    hi = t.to(torch.bfloat16).contiguous()
    if t.dtype == torch.bfloat16:
        return (hi,) * planes
    out, rest = [hi], t.float() - hi.float()
    for _ in range(planes - 1):
        out.append(rest.to(torch.bfloat16).contiguous())
        rest = rest - out[-1].float()
    return tuple(out)


def sass_count(name: str, opcode: str = "HMMA") -> int:
    """Instructions of ``opcode`` in library ``name``'s SASS, by the
    toolkit's ``cuobjdump -sass`` (from the same toolkit as ``nvcc``); the
    library is built first if needed."""
    path = build_all([name])[name]["path"]
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], check=True,
                         capture_output=True, text=True).stdout
    return len(re.findall(rf"\b{opcode}\b", out))
