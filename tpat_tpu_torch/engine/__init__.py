"""Training engine of the port: schedules, optimizer and the train loop."""
