"""Serving front ends of the port: the token serving engine (``engine``)
and the eigensolver engine (``eigen_engine``)."""
