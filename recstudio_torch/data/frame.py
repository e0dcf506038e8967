"""Frame: a columnar, numpy-backed feature store.

Copy of ``recstudio_tpu/data/frame.py`` without pandas: a Frame is built
from numpy columns (``from_columns``) instead of a DataFrame. Token columns
are int32, float columns float32, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Frame:
    """Dict of equal-length numpy columns."""

    def __init__(self, data: Dict[str, np.ndarray], seq_lens: Optional[Dict[str, np.ndarray]] = None):
        self._data: Dict[str, np.ndarray] = dict(data)
        self._seq_lens: Dict[str, np.ndarray] = dict(seq_lens or {})
        lens = {len(v) for v in self._data.values()}
        if len(lens) > 1:
            raise ValueError(f"column length mismatch: { {k: len(v) for k, v in self._data.items()} }")
        self._length = lens.pop() if lens else 0

    @classmethod
    def from_columns(cls, columns: Dict[str, np.ndarray], field2type: Dict[str, str]) -> "Frame":
        """token -> int32, float -> float32; other types kept as they are."""
        data = {}
        for col, values in columns.items():
            t = field2type.get(col, "float")
            if t.endswith("seq"):
                raise NotImplementedError("sequence fields are not ported yet")
            if t == "token":
                data[col] = np.asarray(values, dtype=np.int32)
            elif t == "float":
                data[col] = np.asarray(values, dtype=np.float32)
            else:
                data[col] = np.asarray(values)
        return cls(data)

    def __len__(self) -> int:
        return self._length

    def __contains__(self, field: str) -> bool:
        return field in self._data

    @property
    def fields(self) -> List[str]:
        return list(self._data.keys())

    def get_col(self, field: str) -> np.ndarray:
        return self._data[field]

    def seq_len_col(self, field: str) -> Optional[np.ndarray]:
        return self._seq_lens.get(field)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        """Row gather: returns {field: rows} for an int/array index."""
        return {k: v[index] for k, v in self._data.items()}

    def subset(self, index) -> "Frame":
        return Frame({k: v[index] for k, v in self._data.items()},
                     {k: v[index] for k, v in self._seq_lens.items()})
