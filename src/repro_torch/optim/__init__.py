"""The optimizer: AdamW on the reference's parameter trees."""
