"""Runtime helpers of the torch port: the progress monitor."""
