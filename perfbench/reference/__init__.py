"""The plain reference and the comparison that decides ``correct``.
Nothing here imports the program."""
