"""AdamW and gradient compression, over the port's parameter modules."""
