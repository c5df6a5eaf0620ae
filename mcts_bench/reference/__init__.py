"""The plain reference: numpy only, no import of the program under test."""
