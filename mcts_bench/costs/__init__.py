"""Operation and byte counts, and the card's published peaks."""
