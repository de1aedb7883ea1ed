"""The plain reference the program is held to: torch only, nothing of the port."""
