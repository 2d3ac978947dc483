"""Traffic: the generators the cells' drivers draw their inputs from,
frozen copies of the program's own, and the closed-loop client."""
