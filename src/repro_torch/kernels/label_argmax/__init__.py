"""Plain PLP weighted-label-mode scoring over pre-gathered tiles."""
