"""Experiment metric sinks, the port's own copy of the JAX package's
``obs/sinks.py``.  The reference logs to W&B only
(``src/utils/wandb_logger.py``); here the same metric schema fans out to:

- ``WandbSink``: the same project/run-name/metric-key scheme
  (wandb_logger.py:15-19,42-59): ``train/loss``, ``train/learning_rate``,
  ``train/loss_<name>``, ``test/{loss,PSNR,SSIM,epochTime}``, step =
  epoch * len(loader) + batch.  Gated on ``wandb`` being importable (it
  needs a network; without it the logger keeps JSONL only).
- ``JsonlSink``: an append-only JSON-lines file, always available.

``ExperimentLogger`` is the facade the trainer talks to; it mirrors the
reference WandBLogger method surface (format_* / log_*).
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional


class JsonlSink:
    def __init__(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {"_step": step, "_t": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")

    def log_image(self, image, name: str):  # images live on disk already
        self.log({"image": name})

    def log_histogram(self, name: str, counts, edges,
                      step: Optional[int] = None):
        self.log({name: {"_type": "histogram",
                         "counts": [int(c) for c in counts],
                         "min": float(edges[0]), "max": float(edges[-1])}},
                 step=step)

    def finish(self):
        self._f.close()


class WandbSink:
    """Thin wrapper; raises ImportError from __init__ if wandb is missing."""

    def __init__(self, args_ns, project: str = "AML-Coursework"):
        import wandb  # gated

        self._wandb = wandb
        try:  # .env WANDB_API_KEY (reference wandb_logger.py:13-14)
            from dotenv import load_dotenv
            load_dotenv()
        except ImportError:
            pass
        key = os.getenv("WANDB_API_KEY")
        if key:
            wandb.login(key=key)
        a = args_ns
        wandb.init(
            project=project,
            name=(
                f"{a.arch}__{a.lossf}_{a.lr:.0e}_{a.train_batch_size}_"
                f"{a.optim}_{a.max_epoch}_freq-transform_{a.use_dwt}"
            ),
            config=vars(a) if not isinstance(a, dict) else a,
        )
        wandb.run.summary["uuid"] = str(uuid.uuid4())
        wandb.run.summary["experiment_time"] = time.strftime(
            "%Y-%m-%d %H:%M:%S", time.localtime()
        )

    def log(self, metrics: dict, step: Optional[int] = None):
        self._wandb.log(metrics, step=step)

    def log_image(self, image, name: str):
        self._wandb.log({"examples": self._wandb.Image(image, caption=name)})

    def log_histogram(self, name: str, counts, edges,
                      step: Optional[int] = None):
        hist = self._wandb.Histogram(
            np_histogram=(list(counts), list(edges)))
        self._wandb.log({name: hist}, step=step)

    def log_model_artifact(self, checkpoint_path: str, name: str):
        """Upload a checkpoint as a W&B model artifact
        (reference wandb_logger.py:66-79)."""
        artifact = self._wandb.Artifact(name=name, type="model")
        if os.path.isdir(checkpoint_path):
            artifact.add_dir(checkpoint_path)
        else:
            artifact.add_file(checkpoint_path)
        self._wandb.log_artifact(artifact)
        print(f"Logged model artifact '{name}' to W&B")

    def finish(self):
        self._wandb.finish()


class ExperimentLogger:
    """Facade with the reference WandBLogger's method surface
    (wandb_logger.py:29-83) over N sinks."""

    def __init__(self, config, save_dir: str = ""):
        self.config = config
        self.evaluate = getattr(config, "evaluate", False)
        self.watching = False
        self.sinks = []
        if save_dir:
            self.sinks.append(JsonlSink(os.path.join(save_dir, "metrics.jsonl")))
        if getattr(config, "use_wandb", False) and not self.evaluate:
            try:
                self.sinks.append(WandbSink(config))
            except Exception as e:  # wandb missing / no network: degrade
                print(f"wandb disabled ({type(e).__name__}: {e}); using JSONL only")

    # -- format_* parity ----------------------------------------------------
    @staticmethod
    def format_train_metrics(loss, learning_rate):
        return {"train/loss": loss, "train/learning_rate": learning_rate}

    @staticmethod
    def format_loss_metrics(loss, loss_name):
        return {"train/loss_" + loss_name: loss}

    @staticmethod
    def format_test_metrics(loss, psnr, ssim, epoch_time):
        return {
            "test/loss": loss,
            "test/PSNR": psnr,
            "test/SSIM": ssim,
            "test/epochTime": epoch_time,
        }

    # -- log_* parity --------------------------------------------------------
    def log_train_metrics(self, metrics, epoch, batch_idx, trainloader_len):
        step = epoch * trainloader_len + batch_idx
        for s in self.sinks:
            s.log(metrics, step=step)

    def log_test_metrics(self, metrics, step=None):
        if self.evaluate:
            return
        for s in self.sinks:
            s.log(metrics, step=step)

    def log_metrics_per_epoch(self, metrics, epoch):
        if self.evaluate:
            return
        for s in self.sinks:
            s.log(metrics, step=epoch)

    def log_image(self, image, name):
        if self.evaluate:
            return
        for s in self.sinks:
            s.log_image(image, name)

    def log_model_artifact(self, checkpoint_path, name=None):
        if self.evaluate:
            return
        if name is None:
            a = self.config
            name = (f"{getattr(a, 'arch', 'model')}_"
                    f"{getattr(a, 'lr', 0):.0e}_"
                    f"{getattr(a, 'train_batch_size', 0)}_"
                    f"{getattr(a, 'optim', '')}")
        for s in self.sinks:
            if hasattr(s, "log_model_artifact"):
                s.log_model_artifact(checkpoint_path, name)

    def watch_model(self, *_a, **_k):
        """Reference wandb.watch(model, log="all", log_freq=100)
        (wandb_logger.py:25-27): enables the parameter/gradient histogram
        channel.  The trainer computes the histograms on the device
        (``train.trainer.make_watch_step``) and feeds them through
        ``log_histograms``."""
        if not self.evaluate:
            self.watching = bool(self.sinks)

    def log_histograms(self, hists: dict, step: Optional[int] = None):
        """hists: {name: (counts, bin_edges)} numpy pairs."""
        if self.evaluate:
            return
        for s in self.sinks:
            if hasattr(s, "log_histogram"):
                for name, (counts, edges) in hists.items():
                    s.log_histogram(name, counts, edges, step=step)

    def finish(self):
        for s in self.sinks:
            s.finish()
