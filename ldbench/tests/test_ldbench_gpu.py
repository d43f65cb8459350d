"""On the card: a small run of each entry through the whole harness, and
the float32 control failing the comparison there. Marked `gpu`; each test
decides for itself whether a card is there, and skips where torch sees
none."""

import pytest
import torch

from ldbench import control
from ldbench import run as R

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return "cuda"


@pytest.mark.parametrize("name,kw", [
    ("kg3_phased.engine_far", dict(regions=[9000, 9000])),
    ("kg3_unphased.engine_far", dict(regions=[9000, 9000])),
    ("kg3_phased.calc_diag", dict(regions=[9000]))])
def test_small_run_on_the_card(card, name, kw):
    cell, cfg = R.load_cell(name)
    cell = dict(cell, **kw)
    line, _ = R.run_cell(name, 2 ** 32 + 5, 1.0, 1, device=card, cell=cell,
                         config=cfg)
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0


def test_control_fails_on_the_card(card):
    cell, cfg = R.load_cell("kg3_phased.calc_diag")
    cell = dict(cell, regions=[9000])
    nums = control.control_numbers("kg3_phased.calc_diag", 7, card, cell,
                                   cfg)
    assert any(nums[k] > v for k, v in cell["limits"].items() if k in nums)
