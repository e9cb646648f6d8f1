"""Host encoder pieces of the q10/q11 device pipeline."""
