"""Experiment loggers: TensorBoard / Weights & Biases scalar + image sinks.

Port of ``gsl_tpu/training/loggers.py`` (already torch-based there): a
small duck-typed sink with `log_scalars`, `log_image` and `finish`, picked
by the fit's ``logger`` field. The per-image CSV (metrics/<split>.csv) and
train_log.csv are always written regardless of the chosen logger.
"""
from __future__ import annotations

import os


class NullLogger:
    def log_scalars(self, scalars: dict, step: int) -> None:
        pass

    def log_image(self, tag: str, img_uint8, step: int) -> None:
        pass

    def finish(self) -> None:
        pass


class TensorBoardLogger(NullLogger):
    def __init__(self, output_dir: str):
        from torch.utils.tensorboard import SummaryWriter
        self.writer = SummaryWriter(os.path.join(output_dir, "tb"))

    def log_scalars(self, scalars, step):
        for k, v in scalars.items():
            self.writer.add_scalar(k, float(v), step)

    def log_image(self, tag, img_uint8, step):
        # HWC uint8
        self.writer.add_image(tag, img_uint8, step, dataformats="HWC")

    def finish(self):
        self.writer.flush()
        self.writer.close()


class WandbLogger(NullLogger):
    def __init__(self, output_dir: str, project: str = "gsl_tpu",
                 name: str | None = None):
        import wandb  # gated: not shipped in every image
        self.wandb = wandb
        self.run = wandb.init(
            project=os.environ.get("WANDB_PROJECT", project),
            name=name or os.path.basename(os.path.normpath(output_dir)),
            dir=output_dir, reinit=True)

    def log_scalars(self, scalars, step):
        self.run.log({k: float(v) for k, v in scalars.items()}, step=step)

    def log_image(self, tag, img_uint8, step):
        self.run.log({tag: self.wandb.Image(img_uint8)}, step=step)

    def finish(self):
        self.run.finish()


def make_logger(kind: str, output_dir: str):
    """'tensorboard' | 'wandb' | '' / 'none' -> logger sink. A backend
    that cannot start degrades to NullLogger with a printed warning instead
    of failing the run: training is too expensive to lose to a logging
    import."""
    kind = (kind or "none").lower()
    if kind in ("none", "", "csv"):
        return NullLogger()
    try:
        if kind in ("tensorboard", "tb"):
            return TensorBoardLogger(output_dir)
        if kind in ("wandb", "w&b"):
            return WandbLogger(output_dir)
    except Exception as e:  # noqa: BLE001 - degrade, don't kill training
        print(f"[logger] {kind} unavailable ({e}); falling back to CSV-only")
        return NullLogger()
    raise ValueError(f"unknown logger '{kind}' "
                     "(expected none|tensorboard|wandb)")
