"""Port CasPSMNet vs the flax CasPSMNet of the JAX package, eval, f32, on the CPU.

The whole-model tests of `tests/test_torch_casnet.py` (`model_tests`),
bound to CasPSMNet, with its own JAX compile: the two cascades in one
file took ~20 s under `-n 6`. Sizes, seeds and tolerances as there.
"""

import pytest

from test_torch_casnet import model_ports, model_references, model_tests
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def references():
    return model_references("CasPSMNet", 1)


@pytest.fixture(scope="module")
def ports(references):
    return model_ports(references)


globals().update(model_tests(["CasPSMNet"]))
