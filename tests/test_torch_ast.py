"""The port's AST against the JAX package's, in f32 on the CPU (where the
port takes the plain versions of its kernels and the JAX model its unfused
path), never calling the JAX model's ``init``: the JAX variables are the
port's ``state_dict`` through ``tools/convert_checkpoint.py convert_ast``.

- forward parity at img_size 32 / embed_dim 8 / win_size 4 (shift masks at
  8² and above, the window clamped to the map at 2² and 4²) and at
  img_size 64 / win_size 8 (masks at 16² and above), batch 2;
- ``params_from_jax`` inverts ``convert_ast`` (transposed-conv taps
  flipped back, Linear kernels transposed, depthwise kernels to OIHW);
- ``load_reference_state_dict`` drops the reference's
  ``relative_position_index`` buffers and loads the rest strict;
- every LN+LeFF call gets contiguous channels-last tokens (the CUDA
  kernel's layout);
- the ``token_mlp="mlp"`` block matches the JAX ``Mlp``;
- every parameter's gradient of an ``L1withColor`` loss, in training mode
  at ``drop_path_rate=0`` (the JAX rng stream cannot be reproduced), against
  ``jax.grad`` of the JAX AST at img_size 32 / win_size 4 with one block a
  level (two at the bottleneck and the last decoder level, which then has
  a shifted, masked block), batch 2, mapped through ``params_from_jax``;
- an unknown token mixer raises (``token_mlp="frfn"`` builds:
  ``tests/test_torch_new_model.py`` holds it against the JAX AST), and
  training at a non-zero rate needs a DropPath generator: with one, it
  runs and returns gradients.

The weights are redrawn so every branch is O(1) and the attention far from
uniform (the reference init, trunc_normal(0.02) Linears and bias tables,
leaves both branches small and the softmax nearly flat): Linears
N(0, 1/fan_in) with biases of std 0.1, bias tables of std 1, mix weights
(0.3, -0.4); the output then reaches |y| ~ 20-50.  Tolerance 3e-5 x
max(1, max|ref|): f32 sums in another order through 18 blocks (readings
4e-6 and 1e-5 of max|ref|).  Gradients: 1e-4 of the largest gradient,
as ``tests/test_torch_train.py`` (f32 sums in another order through the
forward and the backward of 11 blocks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_restoration_tpu.losses import (
    LossFunction as JaxLossFunction,
)
from underwater_image_restoration_tpu.models.ast import AST as JaxAST
from underwater_image_restoration_tpu.models.blocks import Mlp as JaxMlp
from underwater_image_restoration_tpu.tools.convert_checkpoint import (
    convert_ast,
    convert_state_dict,
)
from underwater_image_restoration_torch.losses import LossFunction
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.models.blocks import (
    Mlp,
    WindowAttentionSparse,
)
from underwater_image_restoration_torch.ops import ln_leff_plain
from underwater_image_restoration_torch.tools.convert import (
    flatten,
    load_reference_state_dict,
    params_from_jax,
)

CONFIGS = {"32-win4": dict(img_size=32, embed_dim=8, win_size=4),
           "64-win8": dict(img_size=64, embed_dim=8, win_size=8)}


@torch.no_grad()
def _informative(model, seed):
    g = torch.Generator().manual_seed(seed)

    def n(p, std):
        p.copy_(torch.randn(p.shape, generator=g) * std)

    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            n(m.weight, m.in_features ** -0.5)
            n(m.bias, 0.1)
        elif isinstance(m, WindowAttentionSparse):
            n(m.relative_position_bias_table, 1.0)
            if m.w is not None:
                m.w.copy_(torch.tensor([0.3, -0.4]))
    for name, p in model.named_parameters():
        if ".norm" in name:
            n(p, 0.1)
            if name.endswith("weight"):
                p.add_(1.0)
    return model


def _port(cfg, seed=0):
    return _informative(init_model("AST", device="cpu", seed=seed, **cfg),
                        seed + 100)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    cfg = CONFIGS[name]
    port = _port(cfg)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = jax.tree.map(jnp.asarray, convert_state_dict("AST", sd))
    s = cfg["img_size"]
    x = np.random.default_rng(1).uniform(-1, 1, (2, s, s, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(JaxAST(**cfg).apply)(variables,
                                                   jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 3, s, s) and got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(want - x).max() > 0.5  # the network's branch is O(1)
    np.testing.assert_allclose(
        got, want, atol=3e-5 * max(1.0, float(np.abs(want).max())), rtol=0)


def test_params_from_jax_inverts_convert_ast():
    port = _port(CONFIGS["32-win4"], seed=2)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    flat = convert_ast(sd)
    # the JAX layout of a transposed conv: HWIO with the taps flipped
    dk = sd["upsample_0.deconv.0.weight"]
    np.testing.assert_array_equal(
        flat["upsample_0/deconv/kernel"],
        np.transpose(dk, (2, 3, 0, 1))[::-1, ::-1])
    assert flat["upsample_0/deconv/kernel"].shape == (2, 2) + dk.shape[:2]
    back = params_from_jax(flatten(convert_state_dict("AST", sd)["params"]))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    fresh = init_model("AST", device="cpu", seed=3, **CONFIGS["32-win4"])
    fresh.load_state_dict(back, strict=True)


def test_reference_state_dict_drops_position_index():
    port = _port(CONFIGS["32-win4"], seed=4)
    sd = dict(port.state_dict())
    assert not any("relative_position_index" in k for k in sd)
    for k in [k for k in sd if k.endswith("relative_position_bias_table")]:
        sd[k.replace("bias_table", "index")] = torch.zeros(1)
    assert sum("relative_position_index" in k for k in sd) == 10
    model = init_model("AST", device="cpu", seed=5, **CONFIGS["32-win4"])
    load_reference_state_dict(model, {"model_state_dict": sd})
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_blocks_pass_contiguous_tokens(monkeypatch):
    """Every LN+LeFF call gets contiguous channels-last tokens, which the
    CUDA kernel requires (the convolutions' NCHW output is laid out anew
    once, at the level's entry, not in every block)."""
    import underwater_image_restoration_torch.models.ast as ast_module

    seen = []

    def spy(x, *args, **kwargs):
        seen.append(x.is_contiguous())
        return ln_leff_plain(x, *args, **kwargs)

    monkeypatch.setattr(ast_module, "ln_leff_plain", spy)
    model = init_model("AST", device="cpu", **CONFIGS["32-win4"])
    with torch.no_grad():
        model(torch.zeros(1, 3, 32, 32), use_kernels=False)
    assert seen == [True] * 18


def test_mlp_token_mixer_matches_jax():
    """``token_mlp="mlp"``: fc1 -> gelu -> fc2 (the JAX package's
    ``models/blocks.py Mlp``), with the reference's names."""
    block = Mlp(8, 32)
    _informative(block, 7)
    x = np.random.default_rng(8).standard_normal((2, 16, 8)).astype(
        np.float32)
    params = {n: {"kernel": getattr(block, n).weight.detach().numpy().T,
                  "bias": getattr(block, n).bias.detach().numpy()}
              for n in ("fc1", "fc2")}
    want = np.asarray(JaxMlp(32, 8).apply({"params": params},
                                          jnp.asarray(x)))
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


def test_gradients_match_jax():
    cfg = dict(CONFIGS["32-win4"], depths=(1, 1, 1, 1, 2, 1, 1, 1, 2),
               drop_path_rate=0.0)
    port = _port(cfg, seed=6).train()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert_state_dict("AST", sd))
    rng = np.random.default_rng(9)
    x, y = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    jloss = JaxLossFunction("L1withColor")
    want = jax.jit(jax.grad(lambda p: jloss(
        JaxAST(**cfg).apply(p, jnp.asarray(x)), jnp.asarray(y))))(params)
    want = params_from_jax(flatten(want["params"]))
    loss = LossFunction("L1withColor")(
        port(torch.from_numpy(x).permute(0, 3, 1, 2)),
        torch.from_numpy(y).permute(0, 3, 1, 2))
    loss.backward()
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(want)
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        assert named[name].grad is not None, name
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   atol=1e-4 * top, rtol=0, err_msg=name)


def test_training_and_unported_options_raise():
    with pytest.raises(ValueError, match="Unknown token_mlp"):
        init_model("AST", device="cpu", token_mlp="conv",
                   **CONFIGS["32-win4"])
    init_model("AST", device="cpu", token_mlp="frfn", **CONFIGS["32-win4"])
    model = init_model("AST", device="cpu", **CONFIGS["32-win4"]).train()
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros(1, 3, 32, 32))
    gen = torch.Generator().manual_seed(0)
    model(torch.rand(2, 3, 32, 32) * 2 - 1,
          generator=gen).square().mean().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    with pytest.raises(ValueError, match="32x32"):
        model.eval()(torch.zeros(1, 3, 16, 16))
