"""Training of the port: configuration and the train and eval steps."""
