"""The port's watch histograms (``train/trainer.py make_watch_step`` inside
``ModelTrainer``) against the JAX package's, on the CPU: both trainers run
two SGD epochs (``watch_freq=2``, L1withColor, 32x32, batch 2, f32, 5
train pairs) of a two-convolution model holding the same weights (the JAX
watch step over the SpectralTransformer's 220 tensors costs 30 s of
compile; the harness is ``test_torch_trainer.py``'s).  From the runs'
``metrics.jsonl``: the same names at the same steps (every 2nd of 6),
counts within 1 each, sums equal, the outer edges within 2e-6 of the
larger one's magnitude (the gradients themselves differ by f32 roundoff
between the two frameworks: 1.2e-6 relative on a bias gradient summed over
2048 pixels; the histograms' own edges are held to 1e-6 on identical
inputs in ``test_torch_trainer.py``).  And the watch leaves the train
step's DropPath stream alone: a small AST trains to the same bits with the
watch on every step as without it.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainer import (
    SETTINGS,
    _FixedInit,
    _records,
    _Runs,
    _write_pairs,
)
from underwater_image_restoration_torch.core.config import Config
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.train import trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JaxNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, deterministic=True):
        x = fnn.Conv(4, (3, 3), padding=1)(x)
        return fnn.Conv(3, (1, 1))(jnp.tanh(x)) + x[..., :3]


class _TorchNet(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.conv0 = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.conv1 = torch.nn.Conv2d(4, 3, 1)
        for conv, p in ((self.conv0, params["Conv_0"]),
                        (self.conv1, params["Conv_1"])):
            conv.weight.data = torch.from_numpy(np.ascontiguousarray(
                np.transpose(p["kernel"], (3, 2, 0, 1))))
            conv.bias.data = torch.from_numpy(np.array(p["bias"]))

    def forward(self, x, use_kernels=True):
        y = self.conv0(x)
        return self.conv1(torch.tanh(y)) + y[:, :3]


WATCH_NAMES = {"Conv_0/kernel": "conv0.weight", "Conv_0/bias": "conv0.bias",
               "Conv_1/kernel": "conv1.weight", "Conv_1/bias": "conv1.bias"}


def _hists(run_dir):
    out = {}
    for r in _records(run_dir):
        for k, v in r.items():
            if isinstance(v, dict) and v.get("_type") == "histogram":
                out[(r["_step"], k)] = v
    return out


def test_watch_histograms_match_jax(tmp_path, monkeypatch):
    net = _JaxNet()
    params = jax.tree.map(np.asarray, net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    runs = _Runs(monkeypatch, tmp_path,
                 lambda: _FixedInit(net, {"params": params}),
                 lambda device: _TorchNet(params))
    kw = dict(optim="sgd", lr=0.1, max_epoch=2, watch_freq=2,
              lossf="L1withColor")
    jax_dir = runs.run("jax", "watch", **kw)[0]
    port_dir = runs.run("port", "watch", **kw)[0]
    want, got = _hists(jax_dir), _hists(port_dir)
    renamed = {(s, k.split("/")[0] + "/" + WATCH_NAMES[k.split("/", 1)[1]]):
               v for (s, k), v in want.items()}
    assert sorted(got) == sorted(renamed)
    assert sorted({s for s, _ in got}) == [0, 2, 4]  # every 2nd of 6 steps
    for key, w in renamed.items():
        g = got[key]
        assert sum(g["counts"]) == sum(w["counts"]), key
        diff = np.abs(np.subtract(g["counts"], w["counts"]))
        assert diff.max() <= 1, (key, diff)
        scale = max(abs(w["min"]), abs(w["max"]))
        for end in ("min", "max"):
            assert abs(g[end] - w[end]) <= 2e-6 * scale, (key, end)


def test_watch_leaves_the_drop_path_stream_alone(tmp_path, monkeypatch):
    """A small AST (DropPath at its default rates, drawn from the trainer's
    generator) trains to the same bits with the watch on every step as
    without it: the watch draws from its own generator."""
    dirs = _write_pairs(tmp_path / "data")
    monkeypatch.setattr(trainer, "init_model", lambda arch, **k: init_model(
        "AST", device=k["device"], seed=k["seed"], img_size=32, embed_dim=8,
        win_size=4))
    finals = []
    for watch in (1, 0):
        cfg = Config(checkpoint_dir=str(tmp_path / f"w{watch}"), use_cpu=True,
                     max_epoch=1, watch_freq=watch, **SETTINGS)
        model, _ = trainer.ModelTrainer(*dirs).train(cfg)
        finals.append({n: p.detach().clone()
                       for n, p in model.named_parameters()})
    run = next((tmp_path / "w1").iterdir())
    assert any("gradients/" in k for r in _records(run) for k in r)
    for n, p in finals[0].items():
        assert torch.equal(p, finals[1][n]), n
