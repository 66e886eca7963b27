"""Eval rendering, the train step, its optimizer and train state."""
