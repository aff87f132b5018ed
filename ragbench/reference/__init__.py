"""The plain reference of the served model and its control."""
