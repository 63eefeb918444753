"""Hand-written CUDA kernels of the port, one package per TPU kernel family.

``launch_counts()`` and ``reset_launches()`` cover the wrappers of every
family, by wrapper name, with the fp32 and bf16 instances counted apart
(``<name>_fp32``, ``<name>_bf16``: ``_launches.py``); ``path_counts()``
the load paths of the reduced product and ``syr2k``
(``<name>_bf16_wide``, ...), which ``reset_launches()`` resets too.
"""
from .band_mv import kernel as _band_mv
from .gemm import kernel as _gemm
from .house_panel import kernel as _house_panel
from .rot_apply import kernel as _rot_apply
from .symv import kernel as _symv
from .syr2k import kernel as _syr2k
from .trsm import kernel as _trsm
from .tridiag_eig import kernel as _tridiag_eig

_MODULES = (_tridiag_eig, _symv, _house_panel, _syr2k, _rot_apply, _gemm,
            _trsm, _band_mv)


def launch_counts() -> dict:
    counts: dict = {}
    for mod in _MODULES:
        counts.update(mod.launch_counts())
    return counts


def path_counts() -> dict:
    return {**_symv.path_counts(), **_syr2k.path_counts()}


def reset_launches() -> None:
    for mod in _MODULES:
        mod.reset_launches()
