"""Small value types shared by the port's modules."""
