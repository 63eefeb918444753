"""The LM stack of the port: configs, layers, attention, MoE, Mamba, xLSTM
and the model assembly (``model``), held against the reference's
``repro.models``."""
