"""E-LPIPS, the trainer's perceptual loss and the evaluator's metric
(`api.Metric`)."""
