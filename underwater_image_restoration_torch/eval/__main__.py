from .evaluate import main

main()
