"""ModelTrainer: the training and evaluation engine.

Counterpart of `fcd_tpu/train/trainer.py::ModelTrainer`: model
construction, weights from a seeded initialisation or a fcd_tpu variables
tree through `weights.py`, `inference(volume)`, the training step
(`train_step(images, labels, lr, thickness=None)`, with every loss,
gradient accumulation and `log_layer_norms`), `save_model` / `load_model`
of checkpoints in the JAX trainer's format with the optimizer state, the
step count and the `extra` fields (trainer.py:203-229,
`train/checkpoint.py`), and the epoch loop (trainer.py:358-681): `train`
(the patch loader, augmentation on the card, the steps, validation,
EMA-smoothed early stopping, best and latest checkpoints, resume, the CSV
log, the test at the end), `validate`, `evaluate` (streamed), `test` and
`log_metrics`. The port runs on one card; the JAX trainer's data mesh and
`ragged_dp` paths are `parallel/` (ROADMAP Queue A8).

`train_step` returns the loss as a device tensor and never waits for the
card; the epoch loop reads each step's loss one step late. Dropout and
augmentation draw from generators seeded by params['seed']: a CPU
generator gives each step the seed of the spatial-attention dropout hash,
a generator on the trainer's device draws the dropout masks made in
PyTorch, a CPU generator draws the augmentation's choices and one on the
device its Gaussian noise. None of them reproduces jax.random's streams
(ROADMAP C2).

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

import importlib
import importlib.util
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from fcd_tpu_torch import flags, resolve_device
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.data.augment import (
    apply_augment,
    draw_augment,
    scheduled_probs,
)
from fcd_tpu_torch.data.dataset import FCDDataset, PatchLoader, VolumeLoader
from fcd_tpu_torch.infer.sliding_window import sliding_window_inference
from fcd_tpu_torch.losses.combined import make_combined_loss
from fcd_tpu_torch.metrics import (
    calculate_lesion_wise_metrics,
    calculate_voxel_level_metrics,
)
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.postproc.segment import post_process_prediction
from fcd_tpu_torch.train import checkpoint as ckpt
from fcd_tpu_torch.train.schedule import epoch_lr
from fcd_tpu_torch.train.state import (
    make_optimizer,
    make_train_step,
    param_group_norms,
)
from fcd_tpu_torch.weights import (
    export_flax_variables,
    load_flax_variables,
    param_entries,
)


def _get_wandb():
    """The wandb module when it is installed and WANDB_MODE is not
    "disabled", else None (fcd_tpu/train/trainer.py:40-48). The port has
    no import statement naming it: it is looked up here, at run time."""
    if os.environ.get("WANDB_MODE") == "disabled":
        return None
    if importlib.util.find_spec("wandb") is None:
        return None
    return importlib.import_module("wandb")


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
    latest_model_filename = "latest_model.msgpack"  # fcd_tpu/train/checkpoint.py:18
    best_model_filename = "best_model.msgpack"

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 device=None, verbose: bool = True):
        self.params = get_default_params() if params is None else params
        self.verbose = verbose
        # the compute type is settled before anything reaches the card
        dev = resolve_device(None) if device is None else torch.device(device)
        self.compute_dtype = compute_dtype_for(self.params, dev)
        self.device = resolve_device(dev)
        self.model, self.params = get_model(self.params)
        seed = int(self.params.get("seed", 42))
        gen = torch.Generator().manual_seed(seed)
        self.model.reset_parameters(gen)
        self.model.to(self.device).eval()
        self.model.compute_dtype = self.compute_dtype
        if verbose:
            print("Trainable parameters: "
                  f"{sum(t.numel() for t in self.model.parameters())}")
        self.loss_fn = make_combined_loss(self.params)
        self._step_fn = None
        self.step = 0               # train steps taken (the JAX state.step)
        self._log_norms = bool(self.params.get("log_layer_norms", False))
        self.last_grad_norms = None
        # the augmentation's draws (host) and its Gaussian noise (device)
        self._aug_gen = torch.Generator().manual_seed(seed + 2)
        self._noise_gen = torch.Generator(
            device=self.device).manual_seed(seed + 3)
        self.wandb = _get_wandb()
        self.test_metrics: Dict[bool, Dict[str, float]] = {}
        self.init_stats()

    def init_stats(self) -> None:
        """The validation bookkeeping (a checkpoint's `extra` carries the
        first four)."""
        self.best_val_loss = float("inf")
        self.best_ema_val_loss = float("inf")
        self.best_val_loss_epoch = -1
        self.best_ema_val_loss_epoch = -1
        self.ema_val_loss: Optional[float] = None
        self.early_stopping_counter = 0
        self.log_keys: Optional[List[str]] = None
        self.train_start_time = time.time()

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
        with torch.enable_grad():   # also under a caller's no_grad
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

    # -- evaluation ------------------------------------------------------------

    def _eval_finish(self, logits: torch.Tensor, label: torch.Tensor):
        """The per-volume eval epilogue on the trainer's device (JAX's
        `_eval_finish_fn`): (logits, label) -> (the loss, a uint8 binary
        prediction), so the host fetches a scalar and a uint8 volume."""
        loss = self.loss_fn(logits[None], label[None])
        probs = logits.float()
        if self.params.get("softmax", True) and logits.shape[-1] > 1:
            probs = torch.softmax(probs, dim=-1)
        elif self.params.get("sigmoid", False):
            probs = torch.sigmoid(probs)
        return loss, (probs > 0.5).to(torch.uint8)

    @torch.no_grad()
    def evaluate(self, loader, post_process=True,
                 compute_lesion_level_metrics=False, include_hd95=False,
                 desc="validation"):
        """Per-subject sliding-window evaluation (fcd_tpu/train/trainer.py:
        387-447): the mean loss and the voxel (and lesion) metrics.

        Streamed as the JAX trainer streams it: each volume's inference and
        epilogue are launched, and its loss and mask fetched only once
        FCD_EVAL_QUEUE (default 4) later volumes are in flight, so the
        host's fetch and post-processing overlap the card's work."""
        total_loss, n = 0.0, 0
        all_preds: List[np.ndarray] = []
        all_labels: List[np.ndarray] = []
        fcd_idx = 0 if self.params["chans_out"] == 1 else 1
        window = max(int(flags.get("FCD_EVAL_QUEUE")), 1)
        pending = deque()

        def drain():
            nonlocal total_loss, n
            loss_dev, bin_dev, label = pending.popleft()
            total_loss += float(loss_dev)
            n += 1
            binary = bin_dev.cpu().numpy().astype(np.float32)[None]
            if post_process:
                binary = post_process_prediction(
                    binary, self.params["min_region_size"])
            all_preds.append(binary[0, ..., fcd_idx])
            all_labels.append(label[..., 0])

        for vol in loader:
            logits = self.inference(vol.image)
            label = torch.from_numpy(vol.label).to(self.device)
            loss_dev, bin_dev = self._eval_finish(logits, label)
            pending.append((loss_dev, bin_dev, vol.label))
            if len(pending) > window:
                drain()
        while pending:
            drain()

        metrics = calculate_voxel_level_metrics(
            all_preds, all_labels, compute_hd95=include_hd95)
        if compute_lesion_level_metrics:
            metrics.update(calculate_lesion_wise_metrics(all_preds,
                                                         all_labels))
        if self.verbose:
            for k, v in metrics.items():
                print(f"{k}: {v:.4f}", flush=True)
        return total_loss / max(n, 1), metrics

    def test(self, data_dir: str, test_subjects: Sequence[str],
             post_process=True) -> Dict[str, float]:
        """The test split's voxel, lesion-wise and HD95 metrics, printed
        as two CSV lines (fcd_tpu/train/trainer.py:449-462), and kept in
        `test_metrics[post_process]`."""
        if not test_subjects:
            print("No test subjects provided, skipping testing.")
            return {}
        ds = FCDDataset(data_dir, self.params, test_subjects,
                        verbose=self.verbose)
        _, metrics = self.evaluate(
            VolumeLoader(ds), post_process=post_process,
            compute_lesion_level_metrics=True, include_hd95=True,
            desc="test" + ("_postprocess" if post_process else ""))
        print(",".join(metrics.keys()) + ",", flush=True)
        print(",".join(f"{v:.4f}" for v in metrics.values()) + ",",
              flush=True)
        self.test_metrics[post_process] = metrics
        return metrics

    # -- training --------------------------------------------------------------

    def validate(self, epoch: int, val_loader):
        """Validation loss and metrics, the EMA of the loss, the best and
        EMA-best epochs and the early-stopping counter
        (fcd_tpu/train/trainer.py:466-499)."""
        avg_val_loss, metrics = self.evaluate(
            val_loader, post_process=False,
            compute_lesion_level_metrics=False, include_hd95=False,
            desc="validation")
        new_best = False
        alpha = self.params.get("val_loss_ema_alpha", 0.7)
        if self.ema_val_loss is None:
            self.ema_val_loss = avg_val_loss
        else:
            self.ema_val_loss = ((1 - alpha) * avg_val_loss
                                 + alpha * self.ema_val_loss)
        if avg_val_loss < self.best_val_loss:
            self.best_val_loss = avg_val_loss
            self.best_val_loss_epoch = epoch + 1
            new_best = True
        if self.ema_val_loss < self.best_ema_val_loss:
            self.best_ema_val_loss = self.ema_val_loss
            self.best_ema_val_loss_epoch = epoch + 1
            self.early_stopping_counter = 0
        else:
            self.early_stopping_counter += 1
        if self.verbose:
            print(f"current epoch: {epoch + 1} validation loss: "
                  f"{avg_val_loss:.4f}, ema_val_loss: "
                  f"{self.ema_val_loss:.4f}\nbest validation loss: "
                  f"{self.best_val_loss:.4f} at epoch: "
                  f"{self.best_val_loss_epoch}", flush=True)
        return new_best, metrics, avg_val_loss

    def log_metrics(self, epoch, train_loss, val_loss, ema_val_loss,
                    val_metrics, lr, elapsed_time, csv_path=None):
        """One row of the epoch log, with the JAX trainer's columns in its
        order (fcd_tpu/train/trainer.py:501-534); with log_layer_norms the
        parameter and gradient norms per top-level group."""
        values = {
            "epoch": epoch + 1,
            "train_loss": train_loss,
            "val_loss": val_loss if val_loss is not None else 0,
            "ema_val_loss": ema_val_loss if ema_val_loss is not None else 0,
            **({f"val_{k}": v for k, v in val_metrics.items()}
               if val_metrics else {}),
            "learning_rate": lr,
            "epoch_time": elapsed_time,
        }
        if self._log_norms:
            for k, v in param_group_norms(self.model).items():
                values[f"pnorm_{k}"] = float(v)
            if self.last_grad_norms is not None:
                for k, v in self.last_grad_norms.items():
                    values[f"gnorm_{k}"] = float(v)
        if self.wandb is not None and getattr(self.wandb, "run",
                                              None) is not None:
            total = sum(float(v) ** 2 for v in
                        param_group_norms(self.model).values())
            self.wandb.log({**values, "param_global_norm": total ** 0.5})
        if csv_path:
            if (epoch == 0 or self.log_keys is None
                    or not os.path.exists(csv_path)):
                with open(csv_path, "w") as f:
                    f.write(",".join(values.keys()) + "\n")
                self.log_keys = list(values.keys())
            with open(csv_path, "a") as f:
                f.write(",".join(str(values.get(k, ""))
                                 for k in self.log_keys) + "\n")

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(batch)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def train(self, data_dir: str, train_subjects, val_subjects,
              save_dir: str, test_subjects=(), resume: bool = False,
              timings: Optional[Dict[int, Dict[str, float]]] = None):
        """The epoch loop (fcd_tpu/train/trainer.py:536-681): per epoch the
        patch loader, augmentation on the card, the train steps,
        validation, the best and (keep_latest_model) latest checkpoints and
        the CSV log, until max_epochs or the early stop; then the best
        model's test without and with post-processing. `timings`, when
        given, gets each epoch's seconds: steps, validation, saving and
        logging (the card synchronised at each boundary)."""
        if not train_subjects or not val_subjects:
            raise ValueError(
                "Train and validation subject lists must be non-empty.")
        os.makedirs(save_dir, exist_ok=True)
        p = self.params

        train_ds = FCDDataset(data_dir, p, train_subjects,
                              verbose=self.verbose)
        val_ds = FCDDataset(data_dir, p, val_subjects, verbose=self.verbose)
        train_loader = PatchLoader(train_ds, p, seed=p.get("seed", 42))
        val_loader = VolumeLoader(val_ds)

        latest_path = os.path.join(save_dir, self.latest_model_filename)
        best_path = os.path.join(save_dir, self.best_model_filename)
        log_path = os.path.join(save_dir, "training_log.csv")

        max_epochs = p.get("max_epochs", 300)
        min_epochs = p.get("min_epochs", 0)
        min_lr = p.get("min_lr", 1e-6)
        patience = p.get("early_stopping_patience", 25)

        self.init_stats()
        current_epoch = 0
        if resume and os.path.exists(latest_path):
            loaded = self.load_model(latest_path, with_optimizer=True)
            current_epoch = (loaded + 1) if loaded is not None else 0
            print(f"Loaded existing model weights from {latest_path}")

        if self.wandb is not None and os.environ.get("WANDB_MODE") != \
                "offline":
            try:
                self.wandb.init(
                    project=p.get("wandb_project", "FCD"),
                    name=f"{p['model_type']}_{os.path.basename(save_dir)}",
                    config={**{k: str(v) for k, v in p.items()},
                            "optimizer": "AdamW"})
            except Exception:
                self.wandb = None

        def clock() -> float:
            if timings is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return time.perf_counter()

        use_aug = bool(p.get("augment", True))
        cuda = self.device.type == "cuda"
        self.train_start_time = time.time()
        for epoch in range(current_epoch, max_epochs):
            epoch_start = time.time()
            t0 = clock()
            if self.verbose:
                print("-" * 10)
                print(f"epoch {epoch + 1}/{max_epochs}", flush=True)

            lr = epoch_lr(p, epoch)
            cd_prob, gm_prob = scheduled_probs(p, epoch)

            epoch_loss, step_count = 0.0, 0
            pending = None
            n_steps = -(-len(train_ds) // max(p.get("batch_size", 1), 1))
            for images, labels in train_loader:
                xb, yb = self._to_device(images), self._to_device(labels)
                if use_aug:
                    draws = draw_augment(xb.shape[0], xb.shape[1:4],
                                         self._aug_gen, cd_prob, gm_prob)
                    xb, yb = apply_augment(xb, yb, draws,
                                           generator=self._noise_gen)
                loss = self.train_step(xb, yb, lr)
                # the one-step-lagged loss fetch (trainer.py:620-633): in
                # eager PyTorch `loss.item()` after the next step's launch
                # would wait for that step too. So each step's loss is
                # copied into a pinned host tensor without blocking, an
                # event is recorded behind the copy, and the value is read
                # one step later, while the card runs the next step.
                host = torch.empty((), dtype=torch.float32,
                                   pin_memory=cuda)
                host.copy_(loss.detach(), non_blocking=cuda)
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record()
                if pending is not None:
                    epoch_loss += self._read_loss(*pending)
                    step_count += 1
                    if self.verbose:
                        print(f"\r  {step_count}/{n_steps} "
                              f"loss: {epoch_loss / step_count:.4f}",
                              end="", flush=True)
                pending = (event, host)
            if pending is not None:
                epoch_loss += self._read_loss(*pending)
                step_count += 1
                if self.verbose:
                    print(f"\r  {step_count}/{n_steps} "
                          f"loss: {epoch_loss / step_count:.4f}",
                          end="", flush=True)
            if self.verbose and step_count:
                print(flush=True)
            epoch_loss /= max(step_count, 1)
            t1 = clock()

            # every epoch validates (the JAX trainer's val_interval is 1)
            new_best, val_metrics, val_loss = self.validate(epoch,
                                                            val_loader)
            t2 = clock()
            if new_best:
                self.save_model(best_path, epoch)
                if self.verbose:
                    print("saved new best metric model", flush=True)
            stop_flag = epoch >= min_epochs and (
                self.early_stopping_counter >= patience or lr <= min_lr)

            if p.get("keep_latest_model", False):
                self.save_model(latest_path, epoch)

            elapsed = time.time() - epoch_start
            self.log_metrics(epoch, epoch_loss, val_loss, self.ema_val_loss,
                             val_metrics, lr, elapsed, csv_path=log_path)
            if timings is not None:
                timings[epoch] = {"steps": t1 - t0, "validation": t2 - t1,
                                  "save_log": clock() - t2,
                                  "n_steps": step_count}

            if stop_flag:
                print(f"Early stopping triggered after {epoch + 1} epochs")
                break

        total = time.time() - self.train_start_time
        print(f"Training completed, total time: {total:.2f} seconds")

        if test_subjects:
            if os.path.exists(best_path):
                self.load_model(best_path, with_optimizer=False)
            self.test(data_dir, test_subjects, post_process=False)
            self.test(data_dir, test_subjects, post_process=True)

        if self.wandb is not None and getattr(self.wandb, "run",
                                              None) is not None:
            self.wandb.finish()

    @staticmethod
    def _read_loss(event, host) -> float:
        if event is not None:
            event.synchronize()
        return float(host)
