"""Single-device training: losses, learning-rate schedules and the train step."""
