"""The port's train step against ``repro``'s on the dense archs
(tiny-gemma3: local:global, qk-norm, and its bfloat16 case; tiny-granite;
tiny-minicpm): the loss, every grad leaf, and the state after one AdamW step
with one microbatch, two, and a loss mask.  Cases and tolerances:
``tests/_torch_train_cases.py``."""
import pytest

import _torch_train_cases as T
from _torch_lm_cases import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ARCHS = ("tiny-gemma3", "tiny-granite", "tiny-minicpm")


@pytest.mark.parametrize("name,what", T.cases(ARCHS), ids=lambda v: str(v))
def test_train_step_matches_repro(name, what):
    T.check(name, what)
