"""Host utilities: intervals and granularities."""
