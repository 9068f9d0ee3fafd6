"""The plain references the check compares with; they import nothing of the program."""
