"""One train step of SegResNetVAE_DSA (fp32, CPU) against jax.grad: the
loss with 0.2 times the VAE loss and every gradient, with the VAE's normal
draw fed to both packages (test_torch_port_zoo_train.py's
`check_train_step`, at patch 64, batch 1).

The VAE branch's gradient is ill-conditioned: moving x by 1e-5 of itself
moves most leaves of the JAX gradient by 1-2% (ReLUs and instance norms on
4^3 grids behind the (B, 8192) -> 256 bottleneck; ROADMAP C10). Each leaf
is held to max(1e-2, twice that movement), and nine in ten to 1e-2.
"""

import torch

from tests.test_torch_port_zoo_train import check_train_step

import torch_port_workers

torch_port_workers.share_cores()


def test_segresnetvae_dsa_train_step_matches_jax(monkeypatch):
    with torch.enable_grad():
        check_train_step(monkeypatch, vae=True)
