"""MaskNet, ONN, HFM and AFN: the port against the JAX package.

The checks and their tolerances are ``test_torch_ctr_zoo.py``'s (same
split, weights drawn from the same seed, dropout off): logits in
evaluation and training to 1e-5 absolute + 1e-5 relative, one step's loss
to 1e-5 relative and every gradient to 1e-4 of its largest magnitude +
1e-3 relative, the converter's round trip bit for bit, and the batch
norms' calibrated statistics to 1e-5.
"""
import pytest
import torch

from test_torch_ctr_zoo import (check_forward, check_gradients, check_refresh_net_state,
                                check_round_trip)
from test_torch_ctr_zoo import splits  # noqa: F401 (the module's split fixture)

VARIANTS = ("MaskNet", "MaskNet-parallel", "ONN", "HFM", "HFM-convolution", "HFM-product", "AFN",
            "AFN-single")
BN_VARIANTS = ("ONN", "AFN", "AFN-single")


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
