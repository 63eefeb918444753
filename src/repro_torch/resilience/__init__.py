"""Stage-boundary health verdicts and the degradation ladder."""
