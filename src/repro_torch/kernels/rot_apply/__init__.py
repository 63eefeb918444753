"""Givens rotations of TT2 and TT4: ``rot_apply``, ``chase_pass``, ``replay_pass``."""
