"""One driver a traffic ``kind``: ``<kind>.py`` defines ``Driver``."""
