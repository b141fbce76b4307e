"""JSON I/O (NumPy copy of rapidnet_tpu.io.jsonio)."""

from rapidnet_tpu_torch.io.jsonio import (dump_json, load_json,
                                          matrix_colmajor, scalar, vector)

__all__ = ["load_json", "dump_json", "scalar", "vector", "matrix_colmajor"]
