"""Model building blocks and the ragged serving step."""
