"""The yardstick: the card's published peaks and the bytes and operations
that a piece of work needs at least, counted from shapes and tree
counts."""
