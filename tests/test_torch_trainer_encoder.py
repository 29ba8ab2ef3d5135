"""``test_torch_trainer.py``'s checks with the encoder trained
(``train_encoder``): three steps against the JAX ``Trainer``, recompute on
and off, and the first step's gradient of every parameter against
``jax.grad``."""

import pytest

from tests.test_torch_trainer import check_first_gradients, check_trainer_steps
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("remat", [False, True])
def test_trainer_steps_match_jax_trained_encoder(remat):
    check_trainer_steps(True, remat)


def test_first_gradients_match_jax_trained_encoder():
    check_first_gradients(True)
