"""Host-side data: patch store, train pipeline, offline builders and evaluation sets."""
