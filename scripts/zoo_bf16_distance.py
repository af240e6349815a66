"""How far bf16 arithmetic itself takes a zoo model's 1 x 64^3 train step
from the f32 step, in both packages, on the CPU.

chip_smoke.py's zoo_train_check holds the card's bf16 step to the port's
fp32 CPU step. This script measures, from the same seeded weights (a
ModelTrainer built as zoo_train_check builds it, the weights exported to
the JAX package) and one seeded CPU batch of the same kind, dropout off:

- the JAX package's step with the JAX factory's model at dtype bfloat16
  (its Pallas kernels in interpret mode) and at f32, and
- the port's step on the CPU at bf16 (the kernels' plain versions) and at
  fp32,

and prints each loss and each bf16 loss's relative distance from its own
package's f32 loss, with the two packages' f32 losses against each other.

    python scripts/zoo_bf16_distance.py [UNETR|SWINUNETR|UNET|VNET ...]

Runs on the CPU only (JAX forced to its CPU backend); UNETR at full width
takes a few minutes and a few GB.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from fcd_tpu.config import get_default_params as jax_default_params  # noqa: E402
from fcd_tpu.losses.combined import make_combined_loss as jax_loss  # noqa: E402
from fcd_tpu.models.factory import get_model as jax_get_model  # noqa: E402
from fcd_tpu_torch import weights  # noqa: E402
from fcd_tpu_torch.train.trainer import ModelTrainer  # noqa: E402

# each JAX model's dropout field, set to 0 (the port's side: dropout_off)
DROPOUT_FIELD = {"UNETR": "dropout_rate", "SWINUNETR": "drop_rate",
                 "UNET": "dropout", "VNET": "dropout_prob"}


def jax_losses(model_type, variables, x, y):
    """{"f32": loss, "bf16": loss} of the JAX factory's model, one
    value_and_grad each, train mode, dropout off."""
    out = {}
    for name, amp in (("f32", False), ("bf16", True)):
        jp = jax_default_params()
        jp.update(model_type=model_type, patch_size=x.shape[1], chans_in=2,
                  chans_out=2, loss="DiceCELoss", use_amp=amp)
        fm, _ = jax_get_model(jp)
        fm = fm.clone(**{DROPOUT_FIELD[model_type]: 0.0})
        loss_fn = jax_loss(jp)

        def loss_of(params, xx, fm=fm, loss_fn=loss_fn):
            logits, _ = fm.apply(
                {**variables, "params": params}, xx, train=True,
                rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            return loss_fn(logits, jnp.asarray(y))

        t0 = time.perf_counter()
        loss, _ = jax.jit(jax.value_and_grad(loss_of))(
            variables["params"], jnp.asarray(x))
        out[name] = float(loss)
        print(f"  JAX {name}: loss {out[name]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def port_losses(model_type, state, x, y):
    """{"fp32": loss, "bf16": loss} of the port's CPU step, one each."""
    out = {}
    params = chip_smoke.train_params(chip_smoke.TRAIN_CHECK_SIZE,
                                     extra={"model_type": model_type})
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        tr = ModelTrainer(params, device="cpu", verbose=False)
        tr.model.load_state_dict(state)
        tr.model.compute_dtype = dtype
        chip_smoke.dropout_off(tr.model)
        t0 = time.perf_counter()
        with torch.enable_grad():
            out[name] = float(tr.train_step(torch.from_numpy(x),
                                            torch.from_numpy(y), 1e-4))
        print(f"  port {name}: loss {out[name]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def main(argv):
    torch.set_grad_enabled(False)
    for model_type in argv or ["UNETR"]:
        size = chip_smoke.TRAIN_CHECK_SIZE
        params = chip_smoke.train_params(size,
                                         extra={"model_type": model_type})
        tr = ModelTrainer(params, device="cpu", verbose=False)
        state = {k: v.clone() for k, v in tr.model.state_dict().items()}
        variables = jax.tree_util.tree_map(
            np.asarray, weights.export_flax_variables(tr.model))
        xt, yt = chip_smoke.train_batch(torch.device("cpu"), 1, size,
                                        params["chans_in"])
        x, y = xt.numpy(), yt.numpy()
        print(f"{model_type}: 1x{size}^3 DiceCE step, the port's seeded "
              "weights, a seeded CPU batch, dropout off", flush=True)
        port = port_losses(model_type, state, x, y)
        ref = jax_losses(model_type, variables, x, y)
        print(f"{model_type}: bf16 step's loss rel distance from f32: JAX "
              f"{abs(ref['bf16'] - ref['f32']) / abs(ref['f32']):.3e}, port "
              f"{abs(port['bf16'] - port['fp32']) / abs(port['fp32']):.3e}; "
              f"f32 JAX vs port "
              f"{abs(ref['f32'] - port['fp32']) / abs(ref['f32']):.3e}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
