"""Plain references and frozen copies of the yardstick; they import
nothing of the program."""
