"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Exact on integer-valued data; rtol 1e-5 / atol 1e-4 on gaussian data,
where the kernels sum in another order than the plain versions.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def _data(shape, integer, seed, dev):
    r = np.random.default_rng(seed)
    x = r.normal(size=shape).astype(np.float32)
    if integer:
        x = np.clip(np.round(x * 2), -4, 4).astype(np.float32)
    return torch.from_numpy(x).to(dev)


def _check(got, want, integer):
    if integer:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(37, 91, 50), (200, 1000, 128)])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_pairwise_kernel_matches_plain(card, shape, integer, kernel):
    from repro_torch.kernels import l2_distance as l2
    nq, nx, d = shape
    q = _data((nq, d), integer, 1, card)
    x = _data((nx, d), integer, 2, card)
    before = l2.LAUNCHES
    got = l2.pairwise_distance(q, x, kernel=kernel)
    assert l2.LAUNCHES == before + 1
    _check(got, l2.pairwise_distance_plain(q, x, kernel), integer)


@pytest.mark.parametrize("shape", [(9, 21, 33), (256, 128, 128)])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_gather_kernel_matches_plain(card, shape, integer, kernel):
    from repro_torch.kernels import gather_distance as gd
    b, k, d = shape
    n = 500
    u = _data((b, d), integer, 3, card)
    data = _data((n, d), integer, 4, card)
    r = np.random.default_rng(5)
    ids = torch.from_numpy(r.integers(-1, n, (b, k)).astype(np.int32)).to(card)
    mask = torch.from_numpy(r.random((b, k)) < 0.7).to(card)
    cached = _data((b, k), False, 6, card)
    got = gd.gather_distance_ids(u, data, ids, cached, mask, kernel=kernel)
    _check(got, gd.gather_distance_ids_plain(u, data, ids, cached, mask,
                                             kernel), integer)
    keep = ~mask | (ids < 0)
    assert torch.equal(got[keep], cached[keep])
    c = data[ids.clamp_min(0).long()].contiguous()
    got = gd.gather_distance(u, c, cached, mask, kernel=kernel)
    _check(got, gd.gather_distance_plain(u, c, cached, mask, kernel),
           integer)


def test_card_build_equals_cpu_build_on_integer_data(card):
    from repro_torch.core import vamana
    data = _data((600, 16), True, 7, torch.device("cpu"))
    ps = [vamana.VamanaParams(32, 12, 1.1), vamana.VamanaParams(24, 16, 1.3)]
    gpu = vamana.build_multi_vamana(data, ps, seed=1, device="cuda")
    cpu = vamana.build_multi_vamana(data, ps, seed=1, device="cpu")
    assert torch.equal(gpu.g.ids.cpu(), cpu.g.ids)
    assert gpu.counters == cpu.counters
