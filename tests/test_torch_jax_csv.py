"""The token order of the port's ml-100k ETL, and the JAX package's CSV
path that the parity tests compare it with.

The JAX package reads a CSV through its native library
(``recstudio_tpu.native``) or, when that library is missing, through
pandas. The two give different token ids once rows are filtered (ml-100k
drops ratings below 3 before ids are mapped): the native path keeps each
token in the order of its first appearance in the file, the pandas path in
the order of its first appearance among the rows that survived. The port
follows the native path. The JAX library is built in place by each process
that first needs it, so a test process could load a half-written file from
another and take the pandas path. ``jax_native_csv`` therefore builds the
library for the calling process under its own temporary directory, points
the JAX package at it for the tests that build JAX datasets, and fails, not
skips, if it cannot be loaded.
"""
import contextlib
from pathlib import Path

import pytest

from recstudio_torch.data import SeqDataset

ML100K = Path(__file__).resolve().parents[1] / "recstudio_tpu" / "dataset_demo" / "ml-100k"


@contextlib.contextmanager
def jax_native_csv(lib_dir):
    """Inside the block, the JAX package reads CSV files through its native
    library, built in ``lib_dir`` (a directory of this process's own) unless
    it is there; its library path and load state are restored afterwards."""
    from recstudio_tpu import native
    lib_dir = Path(lib_dir)
    lib_dir.mkdir(parents=True, exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_CSV_LIB_PATH", str(lib_dir / "_libcsv.so"))
        mp.setattr(native, "_csv_lib", None)
        mp.setattr(native, "_csv_tried", False)
        assert native._get_csv_lib() is not None, \
            "the JAX package's native CSV library did not build or load"
        yield


def worker_lib_dir(tmp_path_factory):
    """The library's directory for this test process (each xdist worker has
    a temporary directory of its own)."""
    return tmp_path_factory.getbasetemp() / "jax_native_csv"


def test_jax_native_csv_is_this_processs_library(tmp_path_factory):
    from recstudio_tpu import native
    before = (native._CSV_LIB_PATH, native._csv_lib, native._csv_tried)
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        path = Path(native._CSV_LIB_PATH)
        assert path.parent == tmp_path_factory.getbasetemp() / "jax_native_csv"
        assert path.is_file() and native._csv_lib is not None
    assert (native._CSV_LIB_PATH, native._csv_lib, native._csv_tried) == before


def _read(path):
    """Rows of a tab-separated file with a header line, as lists of str."""
    lines = path.read_text().splitlines()[1:]
    return [ln.split("\t") for ln in lines if ln]


def test_port_token_order_is_first_appearance_in_the_file():
    """User and item ids follow the first appearance of each token in the
    interaction file, read whole, among the tokens that keep a row after
    ratings below 3 are dropped; then the users of the user file not seen
    there. First appearance among the kept rows alone would give another
    order (users 196, 186, 298, ... instead of 196, 186, 22, ...)."""
    rows = _read(ML100K / "ml-100k.inter")
    kept = [r for r in rows if float(r[2]) >= 3.0]
    kept_users, kept_items = {r[0] for r in kept}, {r[1] for r in kept}
    users = [u for u in dict.fromkeys(r[0] for r in rows) if u in kept_users]
    users += [u for u in dict.fromkeys(r[0] for r in _read(ML100K / "ml-100k.user"))
              if u not in kept_users]
    items = [i for i in dict.fromkeys(r[1] for r in rows) if i in kept_items]
    ds = SeqDataset("ml-100k")
    assert list(ds.field2tokens["user_id"]) == ["[PAD]"] + users
    assert list(ds.field2tokens["item_id"]) == ["[PAD]"] + items
    assert users[:5] == ["196", "186", "22", "244", "166"]
    assert list(dict.fromkeys(r[0] for r in kept))[:3] == ["196", "186", "298"]
