"""Plain float32 references; they import nothing of the program."""
