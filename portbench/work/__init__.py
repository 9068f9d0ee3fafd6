"""The work a kernel call and a training iteration must do, counted from shapes."""
