"""Training: AdamW and its schedules, and the fault-tolerant loop."""
