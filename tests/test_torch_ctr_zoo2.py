"""DeepCrossing, IFM, DeepIM, LorentzFM, PPNet and FinalMLP: the port
against the JAX package.

The checks and their tolerances are ``test_torch_ctr_zoo.py``'s (ml-100k
under the fm family's config, 7 fields; weights drawn from the same seed,
dropout off): logits in evaluation and training to 1e-5 absolute + 1e-5
relative, one step's loss to 1e-5 relative and every gradient to 1e-4 of
its largest magnitude + 1e-3 relative (a bias a batch norm in training
mode removes held as float32 noise), the converter's round trip bit for
bit, the batch norms' calibrated statistics to 1e-5, and ``evaluate``
(AUC to 1e-6, logloss to 1e-5 relative) with ``ScorePredictor`` (1e-5)
against the JAX package's. PPNet's gates read the embeddings under
``stop_gradient``: a gradient through them would move the tables' own. ``test_torch_ctr_zoo2_{cross,graph}.py`` hold
the other eight models, ``test_torch_ctr_zoo2_layers.py`` their layers,
``test_torch_ctr_zoo2_fit.py`` phase AJ's bands.
"""
import pytest
import torch

from test_torch_ctr_zoo import (check_evaluate, check_forward, check_gradients,
                                check_refresh_net_state, check_round_trip)
from test_torch_ctr_zoo import splits  # noqa: F401 (the module's split fixture)

VARIANTS = ("DeepCrossing", "IFM", "IFM-bn", "DeepIM", "DeepIM-order5", "LorentzFM", "PPNet",
            "PPNet-bn", "FinalMLP", "FinalMLP-bn", "FinalMLP-nofs")
BN_VARIANTS = ("IFM-bn", "DeepIM-order5", "PPNet-bn", "FinalMLP-bn")
MODELS = ("DeepCrossing", "IFM", "DeepIM", "LorentzFM", "PPNet", "FinalMLP")


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

