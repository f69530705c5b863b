"""Models: the NLP, its reformulations and a few built-in problems."""
