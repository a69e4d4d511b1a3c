"""Host-side data loading and degradation for evaluation."""
