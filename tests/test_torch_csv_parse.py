"""The port's vectorised CSV parse (``data/dataset._read_table``) against
the per-line Python parse it replaced, kept here as the plain version: the
same columns (token text and its order of first appearance, float values
bit for bit) on ml-100k's ``.inter`` and ``.user`` files, on small
synthetic files that exercise separators, line endings, headers and empty
lines, and the same error on a row with the wrong number of fields."""
import os

import numpy as np
import pytest

from recstudio_torch.data.dataset import _DEMO_ROOT, _read_table, _Tokens
from recstudio_torch.data.fields import parse_field

ML100K = os.path.join(_DEMO_ROOT, "dataset_demo", "ml-100k")
INTER_FIELDS = ["user_id:token", "item_id:token", "rating:float", "timestamp:float"]


def read_table_plain(path, header, sep, field_decls, encoding):
    """The parse before the vectorised one: every line split in Python."""
    specs = [parse_field(d) for d in field_decls]
    if any(s.is_seq for s in specs):
        raise NotImplementedError("sequence fields are not ported yet")
    with open(path, "r", encoding=encoding) as f:
        lines = f.read().splitlines()
    skip = 0 if header is None else int(header) + 1
    rows = [ln.split(sep) for ln in lines[skip:] if ln]
    bad = [i for i, r in enumerate(rows) if len(r) != len(specs)]
    if bad:
        raise ValueError(f"{path}: row {bad[0] + skip} has {len(rows[bad[0]])} fields, "
                         f"expected {len(specs)}")
    cols = list(zip(*rows)) if rows else [()] * len(specs)
    out = {}
    for s, col in zip(specs, cols):
        arr = np.asarray(col, dtype=str)
        out[s.name] = arr.astype(np.float64) if s.dtype == "float" else _Tokens(arr)
    return out, {s.name: s.dtype for s in specs}


def assert_same_tables(got, want):
    (g, gt), (w, wt) = got, want
    assert gt == wt and list(g) == list(w)
    for name in w:
        a, b = g[name], w[name]
        if isinstance(b, _Tokens):
            assert isinstance(a, _Tokens), name
            assert a.pool.dtype.kind == b.pool.dtype.kind == "U", name
            assert a.pool.tolist() == b.pool.tolist(), name
            np.testing.assert_array_equal(a.codes, b.codes, err_msg=name)
        else:
            assert a.dtype == b.dtype == np.float64, name
            np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64), err_msg=name)


def both(*args):
    return _read_table(*args), read_table_plain(*args)


def test_ml100k_inter_file():
    got, want = both(os.path.join(ML100K, "ml-100k.inter"), 0, "\t", INTER_FIELDS, "utf-8")
    assert len(want[0]["rating"]) == 100_000
    assert_same_tables(got, want)


def test_ml100k_user_file():
    fields = ["user_id:token", "age:token", "gender:token", "occupation:token",
              "zip_code:token"]
    got, want = both(os.path.join(ML100K, "ml-100k.user"), 0, "\t", fields, "utf-8")
    assert len(want[0]["user_id"].codes) == 942
    assert_same_tables(got, want)


SYNTHETIC = {
    # a header, CRLF endings, empty lines, a final line with no newline
    "crlf": ("u\ti\tr\r\nb\tx\t1.5\r\n\r\na\ty\t-2e3\r\nb\ty\t0.1", "\t", 0),
    # the two-character separator of ml-1m's files, no header
    "colons": ("3::7::4\n1::7::5\n3::2::1\n\n", "::", None),
    # a comma file whose tokens hold non-ASCII text, a vertical tab and a
    # form feed (line breaks to str.splitlines) and empty fields
    "unicode": ("h,h,h\nü,é,1\n,z,2\x0bq,,3\x0cé,ü,  4.25 \n", ",", 0),
    # two header lines skipped (header = 1), one data row
    "one_row": ("a|b|c\nd|e|f\nk|l|7\n", "|", 1),
    # a header and nothing else
    "empty": ("u\ti\tr\n", "\t", 0),
    # an empty file
    "nothing": ("", "\t", None),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_synthetic_files(case, tmp_path):
    text, sep, header = SYNTHETIC[case]
    path = tmp_path / f"{case}.csv"
    path.write_bytes(text.encode("utf-8"))
    fields = ["u:token", "i:token", "r:float"]
    got, want = both(str(path), header, sep, fields, "utf-8")
    assert_same_tables(got, want)


def test_latin1_file(tmp_path):
    path = tmp_path / "latin1.csv"
    path.write_bytes("a\tb\nZ\xfcrich\t1\nK\xf6ln\t2\nZ\xfcrich\t3\n".encode("latin-1"))
    got, want = both(str(path), 0, "\t", ["city:token", "n:float"], "ISO-8859-1")
    assert got[0]["city"].pool.tolist() == ["Zürich", "Köln"]
    assert_same_tables(got, want)


@pytest.mark.parametrize("row", ["a\tb", "a\tb\t1\t2"])
def test_a_bad_row_raises_with_its_row_number(row, tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text(f"u\ti\tr\nx\ty\t1\n\n{row}\nz\tw\t2\n")
    fields = ["u:token", "i:token", "r:float"]
    with pytest.raises(ValueError) as want:
        read_table_plain(str(path), 0, "\t", fields, "utf-8")
    with pytest.raises(ValueError) as got:
        _read_table(str(path), 0, "\t", fields, "utf-8")
    assert str(got.value) == str(want.value)
    assert "row 2 has" in str(got.value)


def test_sequence_fields_still_raise(tmp_path):
    path = tmp_path / "seq.csv"
    path.write_text("u\ts\nx\t1 2\n")
    with pytest.raises(NotImplementedError):
        _read_table(str(path), 0, "\t", ["u:token", "s:token_seq"], "utf-8")
