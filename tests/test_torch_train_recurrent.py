"""The port's train step against ``repro``'s on the recurrent archs
(tiny-hymba: attention + Mamba heads, the backward through every step of the
chunked selective scan; tiny-xlstm: mLSTM and sLSTM time loops): the loss,
every grad leaf, and the state after one AdamW step with one microbatch,
two, and a loss mask.  Cases and tolerances: ``tests/_torch_train_cases.py``."""
import pytest

import _torch_train_cases as T
from _torch_lm_cases import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ARCHS = ("tiny-hymba", "tiny-xlstm")


@pytest.mark.parametrize("name,what", T.cases(ARCHS), ids=lambda v: str(v))
def test_train_step_matches_repro(name, what):
    T.check(name, what)
