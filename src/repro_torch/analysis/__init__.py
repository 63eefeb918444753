"""repro_torch.analysis — the cost model of the four variants and the
variant router (``variant_model``)."""
