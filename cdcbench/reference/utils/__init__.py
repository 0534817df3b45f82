"""The reference's weight loading."""
