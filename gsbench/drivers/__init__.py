"""The general loops that turn a traffic file into requests or steps."""
