"""The port's LN+GDFN (ops/fused_gdfn.py) against the JAX package's Pallas
kernels, run in interpret mode on the CPU.

- plain ``ln_gdfn`` vs ``fused_gdfn_banded.fused_ln_gdfn_banded`` and
  ``fused_block.fused_ln_gdfn`` at (1, 8, 16, 128), and vs the banded kernel
  alone at (1, 8, 8, 64) (fused_block takes only W % 128 == 0).  Hidden
  width 21 is not a multiple of 8, like the model's 42/85/170/340.
- the operands the CUDA kernel reads (``kernel_weights``: hidden channels in
  chunks of gate pairs, zero-padded hidden width) give the same function
  when used the way the kernel uses them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from underwater_image_restoration_tpu.ops import fused_block, fused_gdfn_banded
from underwater_image_restoration_torch.ops import fused_gdfn
from underwater_image_restoration_torch.ops.layers import layer_norm_channels

C = 8
TOL = 3e-5  # x max(1, max|ref|), as tests/test_fused_attn_composed.py


def _weights(seed, c):
    rng = np.random.default_rng(seed)
    hid = int(c * 2.66)

    def u(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return (1 + 0.1 * rng.standard_normal(c).astype(np.float32),
            0.1 * rng.standard_normal(c).astype(np.float32),
            u(c ** -0.5, c, 2 * hid), u(1 / 3, 3, 3, 2 * hid),
            u(hid ** -0.5, hid, c))


def _case(shape, seed=0):
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    return x, _weights(seed, shape[1])


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _port(x, w):
    return fused_gdfn.ln_gdfn(torch.from_numpy(x),
                              *(torch.from_numpy(a) for a in w))


@pytest.mark.parametrize("ref, shape", [
    (fused_gdfn_banded.fused_ln_gdfn_banded, (1, C, 16, 128)),
    (fused_block.fused_ln_gdfn, (1, C, 16, 128)),
    (fused_gdfn_banded.fused_ln_gdfn_banded, (1, C, 8, 64)),
], ids=["banded-16x128", "whole-16x128", "banded-8x64"])
def test_plain_matches_pallas(ref, shape):
    x, w = _case(shape)
    want = ref(jnp.asarray(x), *(jnp.asarray(a) for a in w))
    _close(_port(x, w).numpy(), want)


def test_cpu_tensor_takes_plain_version():
    x, w = _case((2, C, 8, 8), seed=3)
    before = sum(fused_gdfn.ln_gdfn.launches.values())
    got = _port(x, w)
    want = fused_gdfn.ln_gdfn_plain(torch.from_numpy(x),
                                    *(torch.from_numpy(a) for a in w))
    assert torch.equal(got, want)
    assert sum(fused_gdfn.ln_gdfn.launches.values()) == before


def _emulate_kernel(x, scale, bias, w_in, w_dw, w_out):
    """The CUDA kernel's arithmetic over its own operands: project_in and
    the taps in chunk order [t1 of chunk m, t2 of chunk m], hidden width
    zero-padded to a multiple of GATE_CHUNK."""
    b, c, h, w = x.shape
    win, taps, wo, hp = fused_gdfn.kernel_weights(w_in, w_dw, w_out)
    ln = layer_norm_channels(x, scale, bias)
    t = fused_gdfn.dwconv3x3(fused_gdfn.conv1x1(ln, win),
                             taps.t().reshape(3, 3, 2 * hp))
    t = t.view(b, hp // fused_gdfn.GATE_CHUNK, 2, fused_gdfn.GATE_CHUNK, h, w)
    t1, t2 = (t[:, :, i].reshape(b, hp, h, w) for i in (0, 1))
    return x + fused_gdfn.conv1x1(F.gelu(t1) * t2, wo)


def test_kernel_operand_layout():
    x, w = _case((2, C, 8, 12), seed=5)
    args = [torch.from_numpy(a) for a in (x, *w)]
    win, taps, wo, hp = fused_gdfn.kernel_weights(*args[3:])
    assert hp == 32 and win.shape == (C, 2 * hp)
    assert taps.shape == (2 * hp, 9) and wo.shape == (hp, C)
    _close(_emulate_kernel(*args).numpy(),
           fused_gdfn.ln_gdfn_plain(*args).numpy())
