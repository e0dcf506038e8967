"""Field schema: names, types and separators.

Copy of ``recstudio_tpu/data/fields.py``. The framework keeps the field
convention of the reference (recstudio/data/dataset.py,
data/config/all.yaml): fields are declared as ``name:type[:"sep"]`` where type is
one of ``token`` (categorical id), ``token_seq`` (list of ids), ``float``,
``float_seq`` or ``str``. Canonical roles: ``fuid``/``fiid``/``frating``/``ftime``.
Query-side history fields are prefixed ``in_``; padding index is always 0 and
vocab position 0 is the literal token ``[PAD]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

TOKEN = "token"
TOKEN_SEQ = "token_seq"
FLOAT = "float"
FLOAT_SEQ = "float_seq"
STR = "str"

PAD_TOKEN = "[PAD]"


@dataclass(frozen=True)
class FieldSpec:
    name: str
    dtype: str                 # token / token_seq / float / float_seq / str
    sep: Optional[str] = None  # separator for *_seq fields

    @property
    def is_seq(self) -> bool:
        return self.dtype.endswith("seq")

    @property
    def is_token(self) -> bool:
        return self.dtype.startswith("token")

    @property
    def is_float(self) -> bool:
        return self.dtype.startswith("float")


def parse_field(decl: str) -> FieldSpec:
    """Parse ``name:type[:"sep"]`` declarations."""
    parts = decl.split(":")
    name, dtype = parts[0], parts[1]
    sep = None
    if len(parts) >= 3:
        raw = ":".join(parts[2:])
        sep = raw.strip('"') if raw else None
    return FieldSpec(name, dtype, sep)


def parse_fields(decls: List[str]) -> List[FieldSpec]:
    return [parse_field(d) for d in decls]
