"""Self-application transforms.  Only the weightwise variant is ported."""
