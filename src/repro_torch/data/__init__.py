"""Synthetic GSYEIG pencils shaped like the paper's two workloads
(``problems``) and the LM stack's synthetic token pipeline (``tokens``)."""
