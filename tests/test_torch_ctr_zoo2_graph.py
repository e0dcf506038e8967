"""FiGNN, CCPM and FGCNN, and the criteo layout: the port against the JAX
package.

The checks and their tolerances are ``test_torch_ctr_zoo.py``'s (see
``test_torch_ctr_zoo2.py``), with each model's ``evaluate`` and
``ScorePredictor``. On ml-100k's 7 fields CCPM's heights are 6 and 5
(an even and an odd SAME padding) and FGCNN's pools of 2 leave a row over
(7 fields, then 3, then 1).

On an id-less criteo-layout split (``generate_ctr``: 13 float and 4 token
fields, no user or item id, no feature table) FLEN's, FinalMLP's and
PPNet's default groups are empty or single: the JAX package raises
building them (FLEN's ``r_mf`` has no pair to weigh, the others'
``Embeddings`` no field), and so does the port (``ValueError``). With the
groups phase AI sets on criteo's columns (FLEN's float and token groups,
FinalMLP's streams, PPNet's token gate fields) both packages' logits and
one step's gradients agree.
"""
import numpy as np
import pytest
import torch

from test_torch_ctr_zoo import (check_evaluate, check_forward, check_gradients,
                                check_round_trip)
from test_torch_ctr_zoo import splits  # noqa: F401 (the module's split fixture)

VARIANTS = ("FiGNN", "CCPM", "FGCNN")
CRITEO_VARIANTS = ("FLEN-criteo", "FinalMLP-criteo", "PPNet-criteo")
SPLIT_SEED = 42
CTR_ROWS = 2000
CTR_KW = dict(n_float=13, vocabs=(1600, 300, 40, 6))


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


@pytest.fixture(scope="module")
def ctr_splits(tmp_path_factory):
    """The criteo layout at a small size, read by both packages from the
    file the JAX generator writes."""
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_tpu.data.synthetic import generate_ctr
    from recstudio_torch.data import TripletDataset
    name, config = generate_ctr("ctr-idless", CTR_ROWS, seed=0, **CTR_KW,
                                out_dir=str(tmp_path_factory.mktemp("ctr")))
    config["save_cache"] = False
    build = dict(fmeval=True, split_mode="entry", split_ratio=[0.8, 0.1, 0.1])
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset(name, config=dict(config)).build(**build)
    np.random.seed(SPLIT_SEED)
    theirs = JaxTripletDataset(name, config=dict(config)).build(**build)
    assert ours[0].fuid is None and ours[0].user_feat is None and ours[0].item_feat is None
    return ours, theirs


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant, splits):
    check_forward(variant, splits)


@pytest.mark.parametrize("variant", VARIANTS)
def test_one_step_loss_and_gradients_match_jax(variant, splits):
    check_gradients(variant, splits)


@pytest.mark.parametrize("variant", VARIANTS)
def test_converter_round_trip_is_exact(variant, splits):
    check_round_trip(variant, splits)


@pytest.mark.parametrize("name", VARIANTS)
def test_evaluate_and_score_predictor_match_jax(name, splits):
    check_evaluate(name, splits)


@pytest.mark.parametrize("name,message", [("FLEN", "two field groups"),
                                          ("FinalMLP", "stream has no field"),
                                          ("PPNet", "no gate field")])
def test_default_groups_on_an_idless_dataset_raise_as_jax(name, message, ctr_splits):
    import jax
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    ours, theirs = ctr_splits
    jcls, jconf = jax_get_model(name)
    jmodel = jcls(jconf)
    with pytest.raises((ValueError, ZeroDivisionError)):
        jmodel._init_model(theirs[0])
        jmodel._init_variables = jax.jit(jmodel._init_variables)
        jmodel._init_parameter(theirs[0])
    cls, conf = get_model(name)
    model = cls(conf, device="cpu")
    with pytest.raises(ValueError, match=message):
        model._init_model(ours[0])


@pytest.mark.parametrize("variant", CRITEO_VARIANTS)
def test_criteo_groups_match_jax(variant, ctr_splits):
    check_forward(variant, ctr_splits)
    check_gradients(variant, ctr_splits)
