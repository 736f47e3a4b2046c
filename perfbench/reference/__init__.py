"""The plain reference that decides `correct`: plain PyTorch in float32,
independent of the program under test (it imports none of it)."""
