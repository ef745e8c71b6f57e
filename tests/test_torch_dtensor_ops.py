"""The three ops rewritten for DTensor, and the DTensor helpers' plain path.

MoE's ``_group_ranks`` (a run's start found by ``searchsorted``, no
``cummax``), Mamba's causal conv (windows of the padded sequence, on
each rank's local block for a DTensor) and the mLSTM / sLSTM gates'
``log_sigmoid`` (pointwise ops, no ``log_sigmoid_backward``) each equal
their former form on the CPU: the ranks exactly, the conv's forward bit
for bit and its gradient to fp32 rounding, ``log_sigmoid`` and its
gradient to fp32 rounding; the aten ops they dispatch, recorded by a
``TorchDispatchMode``, leave out the ops some PyTorch releases have no
DTensor rule for.  The helpers of ``distributed/dtensor_ops`` take
exactly the plain op on plain tensors.  On meta DTensors over a fake
(2, 2) process group (a subprocess: the group must stay out of the test
process) the conv runs with d_inner sharded; MoE's routing and the
mLSTM, forward and backward, ask DTensor for no ``index_put_``,
``flip``, ``cummax`` or ``log_sigmoid`` op (those go to local blocks);
and the flash wrapper refuses a DTensor with a TypeError.
"""
import os
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed import dtensor_ops as dt
from repro_torch.models import mamba, moe, xlstm
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


class Ops(TorchDispatchMode):
    """The aten ops dispatched inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func))
        return func(*args, **(kwargs or {}))


def _group_ranks_cummax(sorted_ids):
    """The former form: the last start at or before each entry by a
    running maximum."""
    idx = torch.arange(sorted_ids.shape[0])
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[1:] = sorted_ids[1:] > sorted_ids[:-1]
    start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return idx - start


@pytest.mark.parametrize("n,e", [(1, 1), (7, 1), (7, 7), (64, 4),
                                 (1000, 16), (4096, 128)])
def test_group_ranks_equal_the_cummax_form(n, e):
    gen = torch.Generator().manual_seed(n * 31 + e)
    ids = torch.sort(torch.randint(0, e, (n,), generator=gen)).values
    with Ops() as ops:
        got = moe._group_ranks(ids)
    assert torch.equal(got, _group_ranks_cummax(ids))
    assert got.dtype == torch.int64
    assert not any("cummax" in name for name in ops.names)


def _conv_slices(xin, w, b):
    """The former form: the padded sequence sliced four times."""
    s = xin.shape[1]
    pad = F.pad(xin, (0, 0, mamba.CONV_K - 1, 0))
    xc = sum(pad[:, i:i + s] * w[i] for i in range(mamba.CONV_K))
    return F.silu(xc + b)


@pytest.mark.parametrize("s", [1, 3, 4, 37])
def test_causal_conv_equals_the_sliced_form(s):
    gen = torch.Generator().manual_seed(s)
    xin, g = (torch.randn(2, s, 24, generator=gen) for _ in range(2))
    p = {"conv_w": torch.randn(mamba.CONV_K, 24, generator=gen),
         "conv_b": torch.randn(24, generator=gen)}
    grads = []
    for fn in (lambda x, w, b: mamba._causal_conv(x, {"conv_w": w,
                                                      "conv_b": b}),
               _conv_slices):
        ts = [t.clone().requires_grad_() for t in
              (xin, p["conv_w"], p["conv_b"])]
        out = fn(*ts)
        out.backward(g)
        grads.append((out.detach(), [t.grad for t in ts]))
    (got, gg), (want, gw) = grads
    assert torch.equal(got, want)
    for a, b in zip(gg, gw):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_log_sigmoid_is_pointwise_and_equals_logsigmoid():
    gen = torch.Generator().manual_seed(0)
    x = torch.cat([torch.randn(4096, generator=gen) * 30,
                   torch.tensor([0.0, -0.0, 1e-30, -88.0, 88.0, -200.0,
                                 200.0])]).requires_grad_()
    with Ops() as ops:
        y = xlstm.log_sigmoid(x)
        (gx,) = torch.autograd.grad(y.sum(), x)
    assert not any("log_sigmoid" in name for name in ops.names)
    x2 = x.detach().clone().requires_grad_()
    want = F.logsigmoid(x2)
    (gw,) = torch.autograd.grad(want.sum(), x2)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(gx, gw, rtol=1e-6, atol=1e-7)
    assert gx[4096] == 0.5 and gx[4097] == 0.5     # the gradient at 0


def test_helpers_take_the_plain_op_on_plain_tensors():
    gen = torch.Generator().manual_seed(1)
    a = torch.randn(2, 3, 8, generator=gen)
    b = torch.randn(8, 5, generator=gen)
    c = torch.randn(2, 5, 8, generator=gen)
    ids = torch.randint(0, 8, (2, 3), generator=gen)
    assert not dt.is_dtensor(a)
    assert torch.equal(dt.matmul(a, b), a @ b)
    assert torch.equal(dt.einsum("bsk,btk->bst", a, c),
                       torch.einsum("bsk,btk->bst", a, c))
    assert torch.equal(dt.reshape(a, 6, 8), a.reshape(6, 8))
    assert torch.equal(dt.reshape(a, (-1,)), a.reshape(-1))
    assert torch.equal(dt.lookup(b, ids), b[ids])


def test_meta_dtensors_on_a_fake_group():
    code = (
        "import torch, torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from torch.distributed.device_mesh import init_device_mesh\n"
        "from torch.distributed.tensor import (Replicate, Shard,\n"
        "                                      distribute_tensor)\n"
        "from repro_torch.models import mamba\n"
        "from repro_torch.kernels import flash_attention as fa\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=0,\n"
        "                        world_size=4)\n"
        "mesh = init_device_mesh('cpu', (2, 2),\n"
        "                        mesh_dim_names=('data', 'model'))\n"
        "def put(shape, pl):\n"
        "    return distribute_tensor(torch.empty(shape, device='meta'),\n"
        "                             mesh, pl, src_data_rank=None)\n"
        "x = put((4, 128, 64), [Shard(0), Shard(2)])\n"
        "p = {'conv_w': put((4, 64), [Replicate(), Shard(1)]),\n"
        "     'conv_b': put((64,), [Replicate(), Shard(0)])}\n"
        "y = mamba._causal_conv(x, p)\n"
        "print(tuple(y.shape), [str(q) for q in y.placements],\n"
        "      tuple(y.to_local().shape))\n"
        "from torch.utils._python_dispatch import TorchDispatchMode\n"
        "from torch.distributed.tensor import DTensor\n"
        "from torch.distributed.tensor.experimental import \\\n"
        "    implicit_replication\n"
        "from repro_torch.distributed import sharding\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.models import moe, xlstm\n"
        "class Seen(TorchDispatchMode):\n"
        "    # the ops DTensor itself is asked to run\n"
        "    names = set()\n"
        "    def __torch_dispatch__(self, func, types, args=(), kw=None):\n"
        "        if any(issubclass(t, DTensor) for t in types):\n"
        "            self.names.add(str(func))\n"
        "            return NotImplemented\n"
        "        return func(*args, **(kw or {}))\n"
        "def placed(init, axes):\n"
        "    return {k: dryrun._place(torch.empty(v.shape, device='meta'),\n"
        "                             axes[k], mesh, None).requires_grad_()\n"
        "            for k, v in init.items()}\n"
        "kw = dict(device='meta', dtype=torch.float32)\n"
        "pm = placed(moe.init_moe(None, 64, 128, 4, **kw), moe.moe_axes())\n"
        "px = placed(xlstm.init_mlstm(None, 64, 4, **kw), xlstm.mlstm_axes())\n"
        "with sharding.activate(mesh), implicit_replication(), Seen() as s:\n"
        "    y = moe.moe_ffn(pm, put((64, 64), [Shard(0), Replicate()]),\n"
        "                    n_experts=4)\n"
        "    z = xlstm.mlstm_forward(px, put((4, 128, 64),\n"
        "                                    [Shard(0), Replicate()]))\n"
        "    (y.sum() + z.sum()).backward()\n"
        "bad = sorted(n for n in s.names if n.split('.')[1] in\n"
        "             ('index_put_', 'index_put', 'flip', 'cummax',\n"
        "              'searchsorted',\n"
        "              'log_sigmoid_forward', 'log_sigmoid_backward'))\n"
        "print('dtensor ops', len(s.names), bad)\n"
        "q = put((2, 4, 16, 16), [Shard(0), Shard(1)])\n"
        "kw = dict(causal=True, window=0, softcap=0.0, scale=None,\n"
        "          q_offset=0)\n"
        "for call in (lambda: fa.flash_attention(q, q, q, **kw),\n"
        "             lambda: fa._launch(q, q, q, with_lse=False, **kw),\n"
        "             lambda: fa.flash_attention_backward(q, q, q, q, q,\n"
        "                                                 q, **kw)):\n"
        "    try:\n"
        "        call()\n"
        "    except TypeError as e:\n"
        "        print('refused', e)\n"
        "dist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "(4, 128, 64) ['S(0)', 'S(2)'] (2, 128, 32)"
    # MoE's routing tables, the mLSTM's gates and its cumsum's gradient
    # ask DTensor for none of the ops some releases have no rule for
    assert lines[1].startswith("dtensor ops ") and lines[1].endswith(" []")
    assert len(lines) == 5
    for line in lines[2:]:
        assert line.startswith("refused flash_attention")
        assert "got a DTensor" in line
