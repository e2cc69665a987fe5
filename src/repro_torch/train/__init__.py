"""Single-device training: the train step, checkpoints and the loop."""
