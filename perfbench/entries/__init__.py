"""The entry points a traffic mix drives, one a file, named by its "entry"."""
