"""The LM stack's training: the loss (``loss``), AdamW with its schedule
(``optimizer``), the train, serve and prefill step factories
(``train_step``) and the curvature probe (``spectral``)."""
