"""Hand-written CUDA kernels of the port, one package per TPU kernel family.

``launch_counts()`` and ``reset_launches()`` cover the wrappers of every
family, by wrapper name.
"""
from .symv import kernel as _symv
from .tridiag_eig import kernel as _tridiag_eig

_MODULES = (_tridiag_eig, _symv)


def launch_counts() -> dict:
    counts: dict = {}
    for mod in _MODULES:
        counts.update(mod.launch_counts())
    return counts


def reset_launches() -> None:
    for mod in _MODULES:
        mod.reset_launches()
