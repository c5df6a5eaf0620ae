"""The seeded traffic: one general generator and the Gomoku roots."""
