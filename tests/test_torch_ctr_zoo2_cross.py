"""EDCN, FLEN, SAM, AOANet and DESTINE: the port against the JAX package.

The checks and their tolerances are ``test_torch_ctr_zoo.py``'s (see
``test_torch_ctr_zoo2.py``), with each model's ``evaluate`` and
``ScorePredictor``. DESTINE's unary logits' bias and its queries' and
keys' biases have a zero gradient in exact arithmetic (a softmax over the
fields, the whitening over the fields), as FLEN's first-order bias has
(its batch norm in training mode): both packages' float32 noise there is
held under 1e-6 of the largest gradient.
"""
import pytest
import torch

from test_torch_ctr_zoo import (check_evaluate, check_forward, check_gradients,
                                check_refresh_net_state, check_round_trip)
from test_torch_ctr_zoo import splits  # noqa: F401 (the module's split fixture)

VARIANTS = ("EDCN", "EDCN-attention", "EDCN-concat", "FLEN", "FLEN-groups", "SAM", "SAM-sam3a",
            "AOANet", "DESTINE", "DESTINE-relu")
BN_VARIANTS = ("FLEN", "FLEN-groups")
# EDCN's evaluation runs in its concatenation variant: at the drawn weights
# the default hadamard bridge gives every test row nearly one logit (a spread
# of 1e-5 against float32 differences of 4e-8 between the packages), which
# orders thousands of pairs by rounding
MODELS = ("EDCN-concat", "FLEN", "SAM", "AOANet", "DESTINE")


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant, splits):
    check_forward(variant, splits)


@pytest.mark.parametrize("variant", VARIANTS)
def test_one_step_loss_and_gradients_match_jax(variant, splits):
    check_gradients(variant, splits)


@pytest.mark.parametrize("variant", VARIANTS)
def test_converter_round_trip_is_exact(variant, splits):
    check_round_trip(variant, splits)


@pytest.mark.parametrize("variant", BN_VARIANTS)
def test_refresh_net_state_matches_jax(variant, splits):
    check_refresh_net_state(variant, splits)


@pytest.mark.parametrize("name", MODELS)
def test_evaluate_and_score_predictor_match_jax(name, splits):
    check_evaluate(name, splits)


def test_destine_reads_no_res_mode(splits):
    """The config's ``res_mode`` is read by no JAX module (every attention
    layer adds its residual): another value leaves both packages' logits
    as they are, and equal."""
    check_forward("DESTINE-res-mode", splits)
