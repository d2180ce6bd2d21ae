"""The plain reference the runs are compared with; it imports nothing of
the program."""
