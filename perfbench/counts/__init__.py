"""The least work of a call, counted from the reference."""
