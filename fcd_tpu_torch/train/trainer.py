"""ModelTrainer: inference and the train step.

Counterpart of `fcd_tpu/train/trainer.py::ModelTrainer` with what
`python -m fcd_tpu.cli.infer` needs (model construction, weights from a
seeded initialisation or a fcd_tpu variables tree through `weights.py`,
`inference(volume)`, `_activate`), the training step
(`train_step(images, labels, lr, thickness=None)`, the body of the JAX
trainer's epoch loop, trainer.py:578-635, with every loss, gradient
accumulation and `log_layer_norms`), and `save_model` / `load_model` of
checkpoints in the JAX trainer's format with the optimizer state, the step
count and the `extra` fields (trainer.py:203-229, `train/checkpoint.py`).
The epoch loop, augmentation, the data loaders and validation are queued
in ROADMAP.md.

`train_step` returns the loss as a device tensor and never waits for the
card, as the JAX trainer fetches each step's loss one step late. Its
dropout draws from generators seeded by params['seed']: a CPU generator
gives each step the seed of the spatial-attention dropout hash, and a
generator on the trainer's device draws the masks made in PyTorch.

`inference` always runs the exact static sliding-window engine. The JAX
trainer's `sw_bucket` policy exists only to bound XLA recompiles across
volume shapes; eager PyTorch compiles nothing per shape, and the bucketed
engine's outputs are identical to the exact engine's (fcd_tpu/config.py:
104-107), so the port has no bucketed engine.

The compute type follows the JAX package's model factory
(`fcd_tpu/models/factory.py:21-24`): f32 with `use_amp=False`, else
`params['compute_dtype']` (bfloat16 by default); `compute_dtype_for`
resolves it. On a CUDA device the kernels take bf16 only, so any other
setting raises NotImplementedError when the trainer is built (ROADMAP
C13); the model computes in bf16 there (f32 accumulation and f32 norm
statistics in the kernels). On the CPU it computes in fp32 through the
kernels' plain versions, whatever the setting.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from fcd_tpu_torch import resolve_device
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.infer.sliding_window import sliding_window_inference
from fcd_tpu_torch.losses.combined import make_combined_loss
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.train import checkpoint as ckpt
from fcd_tpu_torch.train.state import make_optimizer, make_train_step
from fcd_tpu_torch.weights import (
    export_flax_variables,
    load_flax_variables,
    param_entries,
)


def compute_dtype_for(params: Dict[str, Any],
                      device: torch.device) -> torch.dtype:
    """The model's compute type on `device`: f32 on the CPU (the kernels'
    plain versions); on a CUDA device the JAX package's choice (f32 with
    use_amp=False, else params['compute_dtype']), which must be bf16."""
    if device.type != "cuda":
        return torch.float32
    name = (str(params.get("compute_dtype", "bfloat16"))
            if params.get("use_amp", True) else "float32")
    if name != "bfloat16":
        raise NotImplementedError(
            f"compute in {name} (use_amp={params.get('use_amp', True)}, "
            f"compute_dtype={params.get('compute_dtype', 'bfloat16')!r}) on "
            "the card: its kernels take bf16 only (ROADMAP C13); set "
            "use_amp=True and compute_dtype='bfloat16', or run on the CPU")
    return torch.bfloat16


def _triple(x):
    if isinstance(x, (tuple, list)):
        return tuple(int(v) for v in x)
    return (int(x),) * 3


class ModelTrainer:
    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 device=None):
        self.params = get_default_params() if params is None else params
        # the compute type is settled before anything reaches the card
        dev = resolve_device(None) if device is None else torch.device(device)
        self.compute_dtype = compute_dtype_for(self.params, dev)
        self.device = resolve_device(dev)
        self.model, self.params = get_model(self.params)
        gen = torch.Generator().manual_seed(int(self.params.get("seed", 42)))
        self.model.reset_parameters(gen)
        self.model.to(self.device).eval()
        self.model.compute_dtype = self.compute_dtype
        self._step_fn = None
        self.step = 0               # train steps taken (the JAX state.step)
        self._log_norms = bool(self.params.get("log_layer_norms", False))
        self.last_grad_norms = None
        self.init_stats()

    def init_stats(self) -> None:
        """The validation bookkeeping a checkpoint's `extra` carries."""
        self.best_val_loss = float("inf")
        self.best_ema_val_loss = float("inf")
        self.ema_val_loss: Optional[float] = None
        self.early_stopping_counter = 0

    def _extra(self) -> Dict[str, Any]:
        return {
            "best_val_loss": self.best_val_loss,
            "best_ema_val_loss": self.best_ema_val_loss,
            "ema_val_loss": (-1.0 if self.ema_val_loss is None
                             else self.ema_val_loss),
            "early_stopping_counter": self.early_stopping_counter,
        }

    def _train_setup(self) -> None:
        seed = int(self.params.get("seed", 42))
        self.optimizer = make_optimizer(self.params, self.model)
        self.loss_fn = make_combined_loss(self.params)
        self._seed_gen = torch.Generator().manual_seed(seed)
        self.model.dropout_rng.generator = torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self._step_fn = make_train_step(self.model, self.loss_fn,
                                        self.optimizer,
                                        grad_norms=self._log_norms)

    def train_step(self, images, labels, lr: float,
                   thickness=None) -> torch.Tensor:
        """One optimizer step (with gradient accumulation, one micro-step)
        on a (B, D, H, W, chans_in) batch with (B, D, H, W, 1) labels at
        learning rate `lr`; `thickness` (B, D, H, W, 1) feeds the cortical
        term. Returns the loss, a 0-d f32 tensor on the trainer's device;
        with log_layer_norms the step's per-group gradient norms are kept
        in `last_grad_norms`."""
        if self._step_fn is None:
            self._train_setup()
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        y = torch.as_tensor(labels, dtype=torch.float32).to(self.device)
        t = (None if thickness is None else
             torch.as_tensor(thickness, dtype=torch.float32).to(self.device))
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self._seed_gen))
        out = self._step_fn(x, y, lr, seed, t)
        self.step += 1
        if self._log_norms:
            out, self.last_grad_norms = out
        return out

    def load_variables(self, variables) -> None:
        """Take the weights of a fcd_tpu variables tree (numpy leaves)."""
        load_flax_variables(self.model, variables)

    def save_model(self, path: str, epoch: Optional[int] = None) -> None:
        """Write a checkpoint in the JAX trainer's format: the weights,
        the optimizer state (a fresh one before the first step), the step
        count, the epoch and the `extra` fields."""
        if self._step_fn is None:
            self._train_setup()
        ckpt.save_checkpoint(
            path, export_flax_variables(self.model), epoch=epoch,
            extra=self._extra(), step=self.step,
            opt_state=ckpt.export_opt_state(self.optimizer,
                                            param_entries(self.model)))

    def load_model(self, path: str, with_optimizer: bool = True):
        """Restore a checkpoint the JAX package (or `save_model`) wrote:
        the weights and running statistics, the step count, the `extra`
        fields onto the attributes of the same names, and, with
        with_optimizer, the optimizer state where the file has one. A
        params-only file restores the weights alone. Returns the epoch
        (None if it has none)."""
        raw = ckpt.read_checkpoint(path)
        if "params" not in raw:
            self.load_variables({"params": raw})
            return None
        self.load_variables({"params": raw["params"],
                             "batch_stats": raw.get("batch_stats", {})})
        self.step = int(np.asarray(raw.get("step", 0)))
        if with_optimizer and "opt_state" in raw:
            if self._step_fn is None:
                self._train_setup()
            ckpt.load_opt_state(self.optimizer, param_entries(self.model),
                                raw["opt_state"])
        extra = raw.get("extra", {})
        if extra:
            self.best_val_loss = float(extra.get("best_val_loss",
                                                 float("inf")))
            self.best_ema_val_loss = float(extra.get("best_ema_val_loss",
                                                     float("inf")))
            ema = float(extra.get("ema_val_loss", -1.0))
            self.ema_val_loss = None if ema < 0 else ema
            self.early_stopping_counter = int(
                extra.get("early_stopping_counter", 0))
        epoch = int(raw.get("epoch", -1))
        return None if epoch < 0 else epoch

    @torch.no_grad()
    def predict(self, patches: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        return self.model(patches)

    @torch.no_grad()
    def inference(self, volume) -> torch.Tensor:
        """Sliding-window logits (D, H, W, chans_out) f32 on the trainer's
        device over a (D, H, W, C) volume (roi = patch_size)."""
        p = self.params
        return sliding_window_inference(
            volume, self.predict,
            roi_size=_triple(p["patch_size"]),
            out_channels=p["chans_out"],
            sw_batch=p.get("sw_batch_size", 2),
            overlap=p.get("sw_overlap", 0.25),
            blend=p.get("sw_blend", "constant"),
            sigma_scale=p.get("sw_sigma_scale", 0.125),
            compute_dtype=self.compute_dtype,
            device=self.device,
        )

    def _activate(self, logits) -> np.ndarray:
        t = torch.as_tensor(logits).float()
        if self.params.get("softmax", True) and t.shape[-1] > 1:
            t = torch.softmax(t, dim=-1)
        elif self.params.get("sigmoid", False):
            t = torch.sigmoid(t)
        return t.cpu().numpy()
