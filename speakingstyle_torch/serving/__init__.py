"""The synthesis engine and its shape lattice."""
