"""Card tests of the sharded search across ranks.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the fixture).  A world-size-1 NCCL group on the card runs the production
backend's code path (the pools meet in an ``all_gather`` of CUDA tensors,
the counts in ``all_reduce``s) and must equal the one-process search bit
for bit; two gloo ranks sharing the card split the shards and must equal
it too.  Each runs in subprocesses, so the test process opens no group.

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_cuda.py
"""
import os
import socket
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

RANK_CODE = r'''
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core import graph, search
from repro_torch.distributed import sharding
backend, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
r = np.random.default_rng(3)
data = r.integers(-127, 128, (2000, 16)).astype(np.float32)
data[np.arange(16), np.arange(16)] = 127
q = r.integers(-127, 128, (64, 16)).astype(np.float32)
dead = np.ones(4, bool); dead[1] = False
tomb = np.array([5, 99, 1500, -1], np.int32)
searches = [{}, dict(visited_impl="hash", expand_width=4), dict(quantize="sq8"),
            dict(routed_shards=2), dict(routed_shards=2, visited_impl="hash"),
            dict(shard_mask=dead), dict(tombstone_ids=tomb)]
one = graph.partition(data, 4, assignment="chunked", degree=12,
                      quantize="sq8", device="cuda")
placed = graph.place_sharded(one, mesh=sharding.search_mesh(4))
bad = 0
for kw in searches:
    a = search.sharded_knn_search(one, q, 10, 32, **kw) if rank == 0 else None
    b = search.sharded_knn_search(placed, q, 10, 32, **kw)
    if rank == 0:
        same = (torch.equal(a.pool_ids, b.pool_ids)
                and torch.equal(a.pool_dist, b.pool_dist)
                and int(a.n_fresh) == int(b.n_fresh)
                and int(a.n_computed) == int(b.n_computed)
                and int(a.hops) == int(b.hops))
        print(kw, "same" if same else "DIFFERENT", flush=True)
        bad += not same
dist.destroy_process_group()
sys.exit(1 if bad else 0)
'''


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the search's kernels are CUDA C++ "
                    "with no interpret mode")
    return torch.device("cuda")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(backend: str, world: int):
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, backend, str(r), str(world), port],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    return [p.returncode for p in procs], outs


def test_nccl_world_size_one_equals_one_process(card):
    rcs, outs = _ranks("nccl", 1)
    assert rcs == [0], outs[0]
    assert outs[0].count("same") == 7, outs[0]


def test_two_gloo_ranks_on_one_card_equal_one_process(card):
    rcs, outs = _ranks("gloo", 2)
    assert rcs == [0, 0], outs
    assert outs[0].count("same") == 7, outs[0]
