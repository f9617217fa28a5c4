"""Training: AdamW and its schedules, the stage-2 SFT step."""
