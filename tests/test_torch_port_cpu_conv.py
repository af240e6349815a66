"""The zoo's library convs on the CPU below f32 (ROADMAP C24).

`ops/layers.py::conv3d` and `conv_transpose3d` hand a bf16 or f16 CPU
tensor's convolution to the library in f32 on its values and round the
result once, as the kernels' plain versions do. oneDNN's bf16 kernels on
a CPU without AMX (its AVX512_CORE_BF16 and AVX512_CORE paths) return a
wrong weight gradient where the grid is not larger than the kernel's
reach: a 3^3 conv over 2^3 (UNet's bottom unit at a 64^3 patch) reads
rel-L2 ~1 from f32, where bf16 rounding alone gives ~3e-3; some runs read
values near 1e33.

`ONEDNN_MAX_CPU_ISA` caps oneDNN's dispatch only before its first call, so
the first test runs the cases in a fresh interpreter with the cap set, on
any x86 host. Each case's input and kernel gradients are held to f32
arithmetic on the same bf16 values within REL_TOL (bf16's own rounding of
the result: measured 2.7e-3 to 2.9e-3). The second test holds the zoo's
3x3 conv at bf16 to B1's plain version (`conv3x3_plain`), bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_workers

torch_port_workers.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-2
ISAS = ("AVX512_CORE_BF16", "AVX512_CORE")
# (name, op, grid, cin, cout, k, stride): UNet's bottom 3^3 conv at 2^3,
# VNet's deepest 5^3 conv at 4^3, a strided 3^3 conv down to 2^3 and
# UNet's k3 s2 transposed conv up from 2^3
CASES = (("conv3d_k3_2", "conv3d", 2, 32, 48, 3, 1),
         ("conv3d_k5_4", "conv3d", 4, 16, 32, 5, 1),
         ("conv3d_k3_s2_4", "conv3d", 4, 32, 48, 3, 2),
         ("conv_transpose3d_k3_s2_2", "conv_transpose3d", 2, 32, 48, 3, 2))

# run in a fresh interpreter with ONEDNN_MAX_CPU_ISA set: prints one JSON
# object {case: [rel-L2 of x's gradient, rel-L2 of the kernel's gradient]}
_CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from fcd_tpu_torch.ops import layers
torch.set_num_threads(1)
out = {}
for name, op, n, ci, co, k, s in json.loads(sys.argv[2]):
    rs = np.random.RandomState(0)
    x0 = torch.from_numpy(rs.standard_normal((1, n, n, n, ci)).astype(
        np.float32)).to(torch.bfloat16).float()
    w0 = torch.from_numpy((0.05 * rs.standard_normal((k, k, k, ci, co)))
                          .astype(np.float32)).to(torch.bfloat16).float()
    grads = []
    for dt in (torch.float32, torch.bfloat16):
        x = x0.clone().to(dt).requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        y = getattr(layers, op)(x, w, None, s)
        g = torch.linspace(-1, 1, y.numel()).view(y.shape).to(dt)
        y.backward(g)
        grads.append((x.grad.float(), w.grad.float()))
    out[name] = [float((a - b).norm() / b.norm())
                 for a, b in zip(grads[1], grads[0])]
print(json.dumps(out))
"""
_RESULTS = {}


def _child(isa):
    if isa not in _RESULTS:
        env = dict(os.environ, ONEDNN_MAX_CPU_ISA=isa)
        run = subprocess.run(
            [sys.executable, "-c", _CHILD, REPO, json.dumps(CASES)],
            env=env, capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-2000:]
        _RESULTS[isa] = json.loads(run.stdout.strip().splitlines()[-1])
    return _RESULTS[isa]


@pytest.mark.parametrize("isa", ISAS)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_bf16_cpu_conv_gradients_without_amx(case, isa):
    rel_x, rel_w = _child(isa)[case]
    assert rel_x <= REL_TOL, (case, isa, rel_x)
    assert rel_w <= REL_TOL, (case, isa, rel_w)


def test_zoo_conv3x3_is_b1_plain_at_bf16():
    from fcd_tpu_torch.kernels.block_conv import conv3x3_plain
    from fcd_tpu_torch.ops.layers import conv3d

    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.standard_normal((1, 4, 4, 4, 8)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(0.1 * rs.standard_normal((3, 3, 3, 8, 16)).astype(
        np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        ours = conv3d(x, w)
        plain = conv3x3_plain([x], [w]).y
    assert ours.dtype == plain.dtype == torch.bfloat16
    assert torch.equal(ours, plain)
