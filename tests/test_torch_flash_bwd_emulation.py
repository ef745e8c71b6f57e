"""The bf16 flash backward's arithmetic, emulated on the CPU
(``tools/emulate_flash_bwd_bf16.py``), in the form the kernel ships: P and
dS rounded once to bf16 as the operands of the tensor-core products, fp32
accumulation, each gradient rounded to bf16 once.  Held to the card's bar,
2e-2 of each gradient's largest magnitude, against the plain backward on
the same bf16 inputs widened to fp32, on three of the flash cases: a
soft-capped one, a window with a soft-cap across query tiles, and one
whose rows attend no key (exact zeros)."""
import ast
import importlib.util
import pathlib

import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)
from repro_torch.kernels import flash_attention as fa

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "emulate_flash_bwd_bf16", _ROOT / "tools" / "emulate_flash_bwd_bf16.py")
emu = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(emu)

CASES = [(fa.FA_CASES[2], 50),     # 64 x 64 causal, soft-cap 30
         (fa.FA_CASES[6], 128),    # 16 x 144, window 48, soft-cap 50
         (fa.FA_CASES[8], 16)]     # 4 x 8, window 3: no row attends a key


@pytest.mark.parametrize("case,dh", CASES)
def test_single_rounding_holds_the_card_bar(case, dh):
    assert emu.TOL == fa_bwd_tol()
    q, k, v, do = emu.inputs(case, dh)
    kw = emu.knobs(case)
    got = emu.emulate(q, k, v, do, **kw, split=False)
    want = fa.flash_attention_backward_plain(
        *(t.float() for t in (q, k, v)), do.float(), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.isfinite(g).all()
    assert emu.ratio(got, want) <= 1.0
    if case is fa.FA_CASES[8]:
        assert all(not g.any() for g in got)


def fa_bwd_tol() -> float:
    """The bf16 backward's bar as the card tests state it."""
    text = (_ROOT / "tests" / "test_torch_cuda.py").read_text()
    line = next(x for x in text.splitlines()
                if x.startswith("FA_BWD_TOL = "))
    return ast.literal_eval(line.split("=", 1)[1].strip())["bfloat16"]
