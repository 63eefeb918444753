"""repro_torch.analysis — the cost model of the four variants and the
variant router (``variant_model``), the LM stack's analytic cost model
(``analytic``) and the audit (``static_audit``)."""
