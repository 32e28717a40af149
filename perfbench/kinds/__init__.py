"""Drivers of traffic kinds: a traffic file's `kind` names one."""
