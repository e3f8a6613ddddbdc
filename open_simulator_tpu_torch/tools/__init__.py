"""Tools of the GPU port that run on the card."""
