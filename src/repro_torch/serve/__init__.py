"""Serving front ends of the port: the eigensolver engine
(``eigen_engine``)."""
