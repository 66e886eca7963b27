"""Eval rendering (the train step comes with a later slice)."""
