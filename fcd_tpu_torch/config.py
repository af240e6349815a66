"""Default configuration, a copy of `fcd_tpu/config.py`.

The port keeps its own copy so that it never imports the JAX package. The
keys and defaults are the same, so a params dict built for one package
configures the other. Keys that only steer TPU formulations
(`sw_bucket*`, ...) are accepted and ignored; the training CLI refuses a
`mesh_data` (`--devices`) of more than one card (ROADMAP Queue A8). `perf_flags`
is honoured: the model factory resolves it against the exported `FCD_*`
variables when a trainer builds its model (`fcd_tpu_torch/flags.py`).
"""

from __future__ import annotations

import copy
from typing import Any, Dict


def get_default_params() -> Dict[str, Any]:
    params: Dict[str, Any] = {}

    # -- experiment tracking ------------------------------------------------
    params['wandb_project'] = 'FCD'

    # -- model --------------------------------------------------------------
    params['model_type'] = 'MS_DSA_NET'
    params['model_returns_vaeloss'] = False   # auto-assigned by get_model
    params['sa_type'] = 'parallel'            # parallel | serial | spatial | channel
    params['feature_size'] = 16
    params['project_size'] = 64               # DSA spatial-attention projection size
    params['patch_size'] = 128

    params['chans_in'] = 2
    params['chans_out'] = 2
    # input sequence file names separated by '+' (files end with .nii.gz)
    params['seq'] = 't1_reg+flair_reg'

    # -- data loading / batching ---------------------------------------------
    params['num_workers'] = 4
    params['samples_per_case'] = 4
    params['augment'] = True                  # random train-time augmentation chain
    params['batch_size'] = 1
    params['gradient_accumulation_steps'] = 1
    params['use_amp'] = True                  # on TPU: bfloat16 compute policy
    params['adjust_lr_with_batch_size'] = False

    # -- post-processing ------------------------------------------------------
    params['min_region_size'] = 50            # -1: keep largest component only

    # -- determinism ----------------------------------------------------------
    params['deterministic'] = 'seed_only'     # 'off', 'seed_only', 'strict'
    params['seed'] = 42

    # -- optimization ----------------------------------------------------------
    params['lr'] = 1e-4
    params['weight_decay'] = 1e-5
    params['min_lr'] = 1e-6
    params['max_epochs'] = 300
    params['min_epochs'] = 120
    params['warmup_epochs'] = 10
    params['early_stopping_patience'] = 25
    # val_loss_ema = (1 - alpha) * val_loss + alpha * val_loss_ema
    params['val_loss_ema_alpha'] = 0.7

    # -- loss ------------------------------------------------------------------
    params['loss'] = 'DiceLoss'
    params['lambda_dice'] = 1.0
    params['lambda_ce'] = 1.0
    params['lambda_focal'] = 1.0
    params['ce_background_weight'] = 0.5
    params['ce_fcd_weight'] = 0.5
    params['gamma_focal'] = 2.0
    params['gdice_wtype'] = 'square'          # 'square', 'simple', 'uniform'
    params['jaccard'] = False
    params['square_pred'] = False
    params['sigmoid'] = False
    params['softmax'] = True

    # -- augmentation schedule ---------------------------------------------------
    params['coarse_dropout_max_prob'] = 0.0
    params['coarse_dropout_start_epoch'] = 0.0
    params['gridmask_max_prob'] = 0.0
    params['gridmask_start_epoch'] = 0.0

    # -- SegResNet family ----------------------------------------------------------
    params['segresnet_upsample_mode'] = 'pixelshuffle'  # nontrainable|deconv|pixelshuffle
    params['segresnet_deeper'] = False

    # -- loss extras ------------------------------------------------------------------
    params['tv_loss_norm'] = 'l1'             # 'l1' or 'l2'
    params['tv_loss_weight'] = 0.0
    params['tvloss_exclude_borders'] = False
    params['boundaryloss_weight'] = 0.0
    params['caloss_weight'] = 0.0

    params['loss_vae_weight'] = 0.2

    params['keep_latest_model'] = False

    # ======================= TPU-native additions =============================
    # Sliding-window inference engine
    params['sw_batch_size'] = 1               # patches per device batch (measured fastest on v5e; reference uses 2)
    params['sw_overlap'] = 0.25
    params['sw_blend'] = 'constant'           # 'constant' | 'gaussian'
    params['sw_sigma_scale'] = 0.125
    # Volume-shape bucketing: 'auto' keeps the exact static-grid engine for
    # the first sw_bucket_auto_shapes distinct volume shapes, then bounds
    # compiles by padding NEW shapes to sw_bucket_multiple-voxel buckets
    # (identical outputs — the original patch grid rides as device data)
    params['sw_bucket'] = 'auto'              # 'auto' | 'on' | 'off'
    params['sw_bucket_multiple'] = 32
    params['sw_bucket_auto_shapes'] = 2

    # Compute policy
    params['compute_dtype'] = 'bfloat16'      # used when use_amp is True
    params['param_dtype'] = 'float32'

    # Device mesh: data-parallel axis size (-1: all devices)
    params['mesh_data'] = -1
    params['donate_buffers'] = True
    # Ragged global batches (batch % mesh != 0): 'pad' keeps the mesh via
    # pad-and-mask (exact loss; see losses sample_mask), 'replicate' runs
    # the exact single-program fallback on every device
    params['ragged_dp'] = 'pad'
    # wandb.watch analogue: per-layer-group param/grad L2 norms in the
    # epoch CSV/wandb row (gnorm_*/pnorm_* columns)
    params['log_layer_norms'] = False

    # Performance gates ({FCD_* gate: value}), resolved when a trainer
    # builds its model; explicitly exported FCD_* env vars win, and
    # os.environ is never written. The registry (defaults, semantics, what
    # each gate does in the port) lives in fcd_tpu_torch/flags.py —
    # `python -m fcd_tpu_torch.flags` prints the knob table.
    params['perf_flags'] = {}

    return params


def merged_params(overrides: Dict[str, Any] | None = None) -> Dict[str, Any]:
    """Default params with `overrides` applied (unknown keys allowed)."""
    params = get_default_params()
    if overrides:
        params.update(copy.deepcopy(overrides))
    return params
