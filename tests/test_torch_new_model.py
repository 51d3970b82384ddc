"""The port's New* family (NewModel, NewBigModel, NewBigFRFNModel) and its
blocks against the JAX package's, in f32 on the CPU, where the port takes
the plain versions of its kernels and the JAX models their unfused path.
The JAX models' ``init`` is never called: their variables are the port's
``state_dict`` through ``tools/convert_checkpoint.py convert_new_family``
(``jax.eval_shape`` of ``init`` gives the tree the converter must match).

- FRFN, FDFP and MDASSA, in both ``use_dwt`` modes: 1e-5 of max|out|;
- NewModel (Wavelet and Fourier), NewBigModel (Wavelet) and
  NewBigFRFNModel (Fourier) at img_size 32, embed_dim 8, batch 2: the
  output within 1e-4 of max|out| (eval mode) and every parameter's
  gradient of an ``L1withColor`` loss at ``drop_path_rate=0`` (training
  mode) within 1e-4 of the largest gradient; the Fourier encoders' dead
  ``norm2`` exactly zero on both sides;
- AST with ``token_mlp="frfn"``: the output within 3e-5 x max(1,
  max|out|), as ``tests/test_torch_ast.py``;
- ``params_from_jax(flatten(convert_new_family(sd)))`` is ``sd`` exactly,
  and ``convert_new_family`` of the port's ``state_dict`` is the JAX
  parameter tree; ``load_reference_state_dict`` drops the reference's dead
  parameters and buffers;
- every LN+LeFF call gets contiguous channels-last tokens;
- a train step on the CPU with DropPath active is finite and seeded, and
  the kernels' route and the plain route draw the same numbers.

The weights are redrawn so every branch is O(1) and the attention far from
uniform: Linears and convs N(0, 0.49/fan_in) with biases of std 0.1, bias
tables of std 1, mix weights (0.3, -0.4), LayerNorm affines perturbed; the
models' outputs then reach |y| ~ 15-150 (at N(0, 1/fan_in) the residual
stacks of two blocks a level grow past 1e5, at 0.25/fan_in the network's
branch falls below 1).
Tolerances: f32 sums in another order (XLA's and cuDNN-free torch's
convolutions, torch's and jnp's FFTs) through 9 to 17 blocks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu import models as jax_models
from underwater_image_restoration_tpu.losses import (
    LossFunction as JaxLossFunction,
)
from underwater_image_restoration_tpu.models import blocks as jax_blocks
from underwater_image_restoration_tpu.tools.convert_checkpoint import (
    convert_new_family,
    convert_state_dict,
    unflatten,
)
from underwater_image_restoration_torch.losses import LossFunction
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.models import blocks
from underwater_image_restoration_torch.ops import ln_leff_plain
from underwater_image_restoration_torch.tools.convert import (
    flatten,
    load_reference_state_dict,
    params_from_jax,
)
from underwater_image_restoration_torch.train import (
    get_optimizer,
    make_train_step,
)

SMALL = dict(img_size=32, embed_dim=8)
MODELS = {"NewModel-Wavelet": ("NewModel", "Wavelet"),
          "NewModel-Fourier": ("NewModel", "Fourier"),
          "NewBigModel-Wavelet": ("NewBigModel", "Wavelet"),
          "NewBigFRFNModel-Fourier": ("NewBigFRFNModel", "Fourier")}


@torch.no_grad()
def _informative(module, seed):
    g = torch.Generator().manual_seed(seed)

    def n(p, std):
        p.copy_(torch.randn(p.shape, generator=g) * std)

    for m in module.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            n(m.weight, 0.7 * m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                n(m.bias, 0.1)
        elif isinstance(m, blocks.WindowAttentionSparse):
            n(m.relative_position_bias_table, 1.0)
            m.w.copy_(torch.tensor([0.3, -0.4]))
    for name, p in module.named_parameters():
        if "norm" in name.rsplit(".", 2)[-2]:
            n(p, 0.1)
            if name.endswith("weight"):
                p.add_(1.0)
    return module


def _jax_params(module):
    """The JAX variables of a port module, through convert_new_family (its
    names prefixed so the converter's renames, which look for a leading
    dot, apply)."""
    sd = {"m." + k: v.numpy() for k, v in module.state_dict().items()}
    tree = unflatten(convert_new_family(sd))["m"]
    return {"params": jax.tree.map(jnp.asarray, tree)}


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _tokens(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_frfn_matches_jax():
    block = _informative(blocks.FRFN(16, 64), 1)
    x = _tokens((2, 64, 16), 2)
    want = jax_blocks.FRFN(16, 64).apply(_jax_params(block), jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("use_dwt", ["Wavelet", "Fourier"])
def test_fdfp_matches_jax(use_dwt):
    block = _informative(blocks.FDFP(16, 32, use_dwt), 3)
    x = _tokens((2, 8, 8, 16), 4)
    want = jax_blocks.FDFP(16, 32, use_dwt=use_dwt).apply(
        _jax_params(block), jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("use_dwt", ["Wavelet", "Fourier"])
def test_mdassa_matches_jax(use_dwt):
    """Self- and cross-attention in 2 x 2 windows of 16 tokens, 4 heads."""
    block = _informative(blocks.MDASSA(16, 4, 4, use_dwt), 5)
    x = _tokens((2, 64, 16), 6)
    want = jax_blocks.MDASSA(16, 4, 0, 4, use_dwt=use_dwt).apply(
        _jax_params(block), jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x), use_kernels=False)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("key", list(MODELS))
def test_model_and_gradients_match_jax(key):
    """One jitted JAX call gives the output and every gradient; the port's
    eval-mode output and its training-mode gradients are held to them."""
    name, use_dwt = MODELS[key]
    cfg = dict(SMALL, use_dwt=use_dwt, drop_path_rate=0.0)
    port = _informative(init_model(name, device="cpu", seed=7, **cfg), 8)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert_state_dict(name, sd))
    rng = np.random.default_rng(9)
    x, y = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    jmodel = getattr(jax_models, name)(**cfg)
    jloss = JaxLossFunction("L1withColor")

    def loss(p):
        out = jmodel.apply(p, jnp.asarray(x))
        return jloss(out, jnp.asarray(y)), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt)
    assert got.shape == (2, 3, 32, 32) and got.dtype == torch.float32
    want = np.asarray(want)
    assert np.abs(want - x).max() > 0.5  # the network's branch is O(1)
    _close(got.permute(0, 2, 3, 1), want, 1e-4)

    want = params_from_jax(flatten(grads["params"]))
    port.train()
    LossFunction("L1withColor")(port(xt), torch.from_numpy(y).permute(
        0, 3, 1, 2)).backward()
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(want)
    top = max(float(g.abs().max()) for g in want.values())
    for pname, g in want.items():
        if use_dwt == "Fourier" and ".norm2." in pname and "encoder" in pname:
            # the quirk: norm2's output is overwritten, so its gradient is
            # exactly zero (None in the port, zeros in make_train_step)
            assert not g.any() and named[pname].grad is None, pname
            continue
        assert named[pname].grad is not None, pname
        np.testing.assert_allclose(named[pname].grad.numpy(), g.numpy(),
                                   atol=1e-4 * top, rtol=0, err_msg=pname)


def test_ast_frfn_matches_jax():
    cfg = dict(SMALL, win_size=4, token_mlp="frfn")
    port = _informative(init_model("AST", device="cpu", seed=10, **cfg), 11)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = jax.tree.map(jnp.asarray, convert_state_dict("AST", sd))
    x = np.random.default_rng(12).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jax_models.AST(**cfg).apply)(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
        atol=3e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("name, use_dwt", [("NewModel", "Wavelet"),
                                           ("NewBigFRFNModel", "Fourier")])
def test_params_from_jax_inverts_convert_new_family(name, use_dwt):
    port = init_model(name, device="cpu", seed=13, use_dwt=use_dwt, **SMALL)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    flat = convert_new_family(sd)
    shapes = jax.eval_shape(
        getattr(jax_models, name)(use_dwt=use_dwt, **SMALL).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    want = {"/".join(str(k.key) for k in path): tuple(v.shape) for path, v
            in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    assert {k: v.shape for k, v in flat.items()} == want
    back = params_from_jax(flat)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    fresh = init_model(name, device="cpu", seed=14, use_dwt=use_dwt, **SMALL)
    fresh.load_state_dict(back, strict=True)


def test_reference_state_dict_drops_dead_entries():
    """The reference's Haar filter buffers, MDASSA's dead norm_q/norm_kv,
    the self-attention's cross kv projection, the cross-attention's self
    one and the position-index buffers are dropped; the rest loads
    strict."""
    port = init_model("NewModel", device="cpu", seed=15, use_dwt="Wavelet",
                      **SMALL)
    sd = dict(port.state_dict())
    dead = ["encoder_0.dwt.w_ll", "encoder_0.idwt.w_hh",
            "decoder_0.mdassa.fdfp.dwt.w_lh",
            "decoder_0.mdassa.norm_q.weight", "decoder_0.mdassa.norm_kv.bias",
            "decoder_0.mdassa.attn.to_qkv.to_kv.weight",
            "decoder_0.mdassa.freq_attn.to_qkv.to_kv_from_q.bias",
            "bottleneck.mdassa.attn.relative_position_index"]
    for k in dead:
        assert k not in sd
        sd[k] = torch.zeros(1)
    model = init_model("NewModel", device="cpu", seed=16, use_dwt="Wavelet",
                       **SMALL)
    load_reference_state_dict(model, {"model_state_dict": sd})
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_blocks_pass_contiguous_tokens(monkeypatch):
    """Every LN+LeFF call (four encoders without the residual, five
    decoders with it) gets contiguous channels-last tokens, the CUDA
    kernel's layout."""
    import underwater_image_restoration_torch.models.new_model as nm

    seen = []

    def spy(x, *args, **kwargs):
        seen.append((x.is_contiguous(), kwargs["residual"]))
        return ln_leff_plain(x, *args, **kwargs)

    monkeypatch.setattr(nm, "ln_leff_plain", spy)
    model = init_model("NewModel", device="cpu", use_dwt="Wavelet", **SMALL)
    with torch.no_grad():
        model(torch.zeros(1, 3, 32, 32), use_kernels=False)
    assert seen == [(True, False)] * 4 + [(True, True)] * 5


def test_train_step_draws_droppath_from_its_generator():
    """Training at drop_path_rate 0.5 (every encoder's draws matter): one
    step is finite, the same seed gives the same loss, another seed another
    loss, and the kernels' route (here the plain versions of the CPU) and
    the plain route draw alike."""
    from underwater_image_restoration_torch.data import synthetic_pair_batch

    raw, ref = synthetic_pair_batch(2, 32, seed=0)

    def step(seed, use_kernels):
        m = init_model("NewModel", device="cpu", seed=17, use_dwt="Fourier",
                       drop_path_rate=0.5, **SMALL)
        gen = torch.Generator().manual_seed(seed)
        st = make_train_step(m, LossFunction("L1withColor"),
                             get_optimizer("adam", m.parameters(), 3e-4),
                             use_kernels=use_kernels, generator=gen)
        out = st(raw, ref)
        dead = [p.grad for n, p in m.named_parameters()
                if n.startswith("encoder_") and ".norm2." in n]
        return float(out["loss"]), gen.get_state(), dead

    a, state_a, dead = step(0, True)
    b, state_b, _ = step(0, False)
    assert np.isfinite(a) and a == b and torch.equal(state_a, state_b)
    assert len(dead) == 8 and not any(g.any() for g in dead)
    assert step(1, True)[0] != a
