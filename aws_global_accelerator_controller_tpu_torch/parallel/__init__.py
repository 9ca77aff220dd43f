"""The fleet planners and their resident device state."""
